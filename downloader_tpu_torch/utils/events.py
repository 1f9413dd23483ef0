"""A minimal Node-style event emitter.

The reference creates one ``EventEmitter`` per job, registers it in an
``EmitterTable`` keyed by file id, and passes it to every stage factory
(upstream lib/main.js:26,81,103); the orchestrator emits ``progress``
after each stage (lib/main.js:139).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, DefaultDict, List


class EventEmitter:
    def __init__(self) -> None:
        self._listeners: DefaultDict[str, List[Callable]] = collections.defaultdict(list)

    def on(self, event: str, listener: Callable) -> Callable:
        self._listeners[event].append(listener)
        return listener

    def off(self, event: str, listener: Callable) -> None:
        try:
            self._listeners[event].remove(listener)
        except ValueError:
            pass

    def emit(self, event: str, *args: Any) -> bool:
        listeners = list(self._listeners.get(event, ()))
        for listener in listeners:
            listener(*args)
        return bool(listeners)
