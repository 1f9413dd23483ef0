"""The traced run's device timeline: ``torch.profiler`` over the run,
cut to the measured window, and the harness's own host spans.

Host spans are ``record_function`` ranges named ``host.<what>``, so they
share the profiler's clock with the device's operations.  The window is
the range ``portbench.window``.  From the events this module reads, per
device, the seconds in which an operation ran (kernels, copies and
fills, overlaps merged), each kernel's launches, and the idle gaps with
the host span that was open at each gap's middle."""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "portbench.window"
_NAME_CHARS = 120


def _kind(event) -> str:
    """``device`` for an operation on a card's timeline (a kernel, copy or
    fill), ``host`` for a range on the host, ``annotation`` for a range the
    profiler mirrors on a card's timeline (``record_function``'s and the
    optimizer's), which is no operation."""
    if event.is_user_annotation() and not str(event.device_type()).endswith("CPU"):
        return "annotation"
    if str(event.device_type()).endswith(("CUDA", "PrivateUse1")):
        return "device"
    return "host"


def records(events) -> List[Tuple[str, str, int, int, int]]:
    """(name, kind, device, start ns, end ns) of the profiler's raw events,
    read as they come, without building its event tree (which takes
    minutes for four cards' twenty seconds)."""
    out = []
    for e in events:
        start = e.start_ns()
        out.append((e.name(), _kind(e), int(e.device_index()), start,
                    start + e.duration_ns()))
    return out


class Timeline:
    """Device operations and host spans inside the window, in seconds
    from the window's start."""

    def __init__(self, window_s: float, ops: List[Tuple[str, int, float, float]],
                 spans: List[Tuple[str, float, float]], devices: List[int]):
        self.window_s = window_s
        self.ops = ops          # (name, device, start, end), clipped to the window
        self.spans = spans      # (name, start, end) of host.* ranges
        self.devices = devices  # the devices the run used

    def busy_intervals(self, device: int, skip: Tuple[str, ...] = ()
                       ) -> List[Tuple[float, float]]:
        """Merged intervals of ``device``'s operations, leaving out those
        whose name starts with one of ``skip``."""
        merged: List[List[float]] = []
        for _, dev, start, end in sorted((o for o in self.ops if o[1] == device
                                          and not o[0].startswith(skip)),
                                         key=lambda o: o[2]):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    def busy_s(self, device: int) -> float:
        return sum(b - a for a, b in self.busy_intervals(device))

    def mean_busy_between(self, start: float, end: float,
                          skip: Tuple[str, ...] = ()) -> float:
        """Seconds between ``start`` and ``end`` in which an operation not
        named in ``skip`` ran, averaged over the devices."""
        return sum(max(0.0, min(b, end) - max(a, start))
                   for d in self.devices for a, b in self.busy_intervals(d, skip)
                   ) / len(self.devices)

    def span_starts(self, name: str) -> List[float]:
        return sorted(start for n, start, _ in self.spans if n == name)

    def mean_busy_s(self) -> float:
        return sum(self.busy_s(d) for d in self.devices) / len(self.devices)

    def idle_share(self) -> Optional[float]:
        """The idlest device's share of the window with nothing running."""
        if not self.ops:
            return None
        return max(1.0 - self.busy_s(d) / self.window_s for d in self.devices)

    def kernels(self, fragment: str) -> List[float]:
        """Durations (s) of every kernel whose name holds ``fragment``."""
        return [end - start for name, _, start, end in self.ops if fragment in name]

    def device_ops(self, top: int = 10) -> List[list]:
        total: Dict[str, float] = defaultdict(float)
        for name, _, start, end in self.ops:
            total[name[:_NAME_CHARS]] += end - start
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle seconds on every used device, summed by the innermost host
        span open at each gap's middle (``host.none`` where none was)."""
        gaps = []
        for device in self.devices:
            edge = 0.0
            for start, end in self.busy_intervals(device) + [(self.window_s,) * 2]:
                if start > edge:
                    gaps.append(((edge + start) / 2, start - edge))
                edge = max(edge, end)
        gaps.sort()
        total: Dict[str, float] = defaultdict(float)
        for name, (_, length) in zip(self._hosts_at([g[0] for g in gaps]), gaps):
            total[name] += length
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def _hosts_at(self, points: List[float]) -> List[str]:
        """The innermost host span open at each of the sorted ``points``,
        in one sweep over the spans by their start."""
        spans = sorted(self.spans, key=lambda s: s[1])
        active: List[Tuple[float, float, str]] = []   # (end, length, name)
        names, i = [], 0
        for t in points:
            while i < len(spans) and spans[i][1] <= t:
                name, start, end = spans[i]
                active.append((end, end - start, name))
                i += 1
            active = [a for a in active if a[0] >= t]
            innermost = min((a[1], a[2]) for a in active)[1] if active else "host.none"
            names.append("idle:" + innermost)
        return names


class Tracer:
    """``span(name)`` marks host work; ``open``/``close`` mark the window.
    Without ``enabled`` every call is free and nothing is recorded."""

    def __init__(self, enabled: bool, devices: List[int]):
        self.enabled = enabled
        self.devices = devices
        self._prof = None
        self._window = None
        self.timeline: Optional[Timeline] = None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def open(self) -> None:
        if self.enabled:
            self._window = torch.profiler.record_function(WINDOW)
            self._window.__enter__()

    def close(self) -> None:
        if self._window is not None:
            self._window.__exit__(None, None, None)
            self._window = None

    def stop(self) -> None:
        """End the profile (synchronising the devices) and read it."""
        if self._prof is None:
            return
        self.close()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        events = records(self._prof.profiler.kineto_results.events())
        self._prof = None
        self.timeline = read_events(events, self.devices)


def read_events(events, devices: List[int]) -> Timeline:
    """The window's :class:`Timeline` from :func:`records` (times in
    nanoseconds on the profiler's clock)."""
    window = [e for e in events if e[0] == WINDOW and e[1] == "host"]
    if not window:
        raise RuntimeError("the profile holds no measured window")
    w0, w1 = window[0][3], window[0][4]
    seconds = (w1 - w0) / 1e9
    ops, spans = [], []
    for name, kind, device, start, end in events:
        if end <= w0 or start >= w1:
            continue
        start, end = (max(start, w0) - w0) / 1e9, (min(end, w1) - w0) / 1e9
        if kind == "device":
            ops.append((name, device, start, end))
        elif kind == "host" and name.startswith("host."):
            spans.append((name, start, end))
    return Timeline(seconds, ops, spans, devices)
