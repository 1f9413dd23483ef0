"""Async hot-path rules: the service's event-loop invariants.

Each rule here encodes one class of defect the service has shipped:

- **ack-settle-atomicity**: an ``await`` between
  ``delivery.ack()``/``.nack()`` and the terminal
  ``registry.transition`` lets ack-woken observers (broker join,
  drain, ``/v1/jobs`` pollers) see a settled-but-not-terminal limbo.
- **unbounded-timeout**: aiohttp treats an
  explicit ``timeout=None`` as UNBOUNDED, not "session default" — a
  black-holed origin rides the watchdog instead of failing over.
- **blocking-call-in-async** (the LoopLagMonitor's raison d'être):
  synchronous file/dir/sleep work on the event loop stalls
  every job on the worker; push it through ``asyncio.to_thread`` or an
  executor.
- **swallowed-cancellation**: catching ``BaseException`` (or bare
  ``except``) in async code without re-raising eats
  ``asyncio.CancelledError`` — cancel tokens, watchdogs, and shutdown
  then hang on a task that refuses to die.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from .core import Finding, ModuleSource, module_checker

# -- ack-settle atomicity ----------------------------------------------

_SETTLE_ATTRS = frozenset({"ack", "nack"})


def _stmt_settle_line(stmt: ast.stmt) -> Optional[int]:
    """Line of a STATEMENT-LEVEL awaited ``.ack()``/``.nack()``
    (``await delivery.ack()`` as an expression statement or the value
    of an assignment).  Settles nested in compound statements are
    checked within their own branch's block instead — a branch that
    settles and returns must not poison the scan of the outer block
    it never flows back into."""
    value = None
    if isinstance(stmt, ast.Expr):
        value = stmt.value
    elif isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        value = stmt.value
    if (isinstance(value, ast.Await)
            and isinstance(value.value, ast.Call)
            and isinstance(value.value.func, ast.Attribute)
            and value.value.func.attr in _SETTLE_ATTRS):
        return value.lineno
    return None


def _iter_blocks(module: ModuleSource) -> Iterable[List[ast.stmt]]:
    for node in module.nodes:
        for attr in ("body", "orelse", "finalbody"):
            block = getattr(node, attr, None)
            if isinstance(block, list) and block \
                    and isinstance(block[0], ast.stmt):
                yield block


@module_checker(
    "ack-settle-atomicity",
    "No await between a delivery .ack()/.nack() and the terminal "
    "registry .transition() that follows it: the ack wakes observers "
    "(broker join, drain, /v1/jobs) who must never see a "
    "settled-but-not-terminal record.")
def check_ack_settle(module: ModuleSource) -> List[Finding]:
    if ".ack(" not in module.text and ".nack(" not in module.text:
        return []  # cheap text gate: most modules never settle deliveries
    # one children-before-parents pass computes, per node: the first
    # await line and the first .transition() call line in its subtree
    # (module.nodes is breadth-first, so reversed = children first)
    first_await: dict = {}
    first_transition: dict = {}
    for node in reversed(module.nodes):
        awaited: Optional[int] = None
        transition: Optional[int] = None
        for child in ast.iter_child_nodes(node):
            child_await = first_await[id(child)]
            if child_await is not None and (awaited is None
                                            or child_await < awaited):
                awaited = child_await
            child_transition = first_transition[id(child)]
            if child_transition is not None and (
                    transition is None or child_transition < transition):
                transition = child_transition
        if isinstance(node, ast.Await):
            awaited = min(awaited or node.lineno, node.lineno)
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "transition"):
            transition = min(transition or node.lineno, node.lineno)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # a nested definition neither awaits nor settles when the
            # enclosing block runs — its body must not leak into the
            # outer scan (its OWN blocks are still scanned directly)
            awaited = None
            transition = None
        first_await[id(node)] = awaited
        first_transition[id(node)] = transition

    def _stmt_blocks(stmt: ast.stmt):
        for attr in ("body", "orelse", "finalbody"):
            block = getattr(stmt, attr, None)
            if isinstance(block, list) and block \
                    and isinstance(block[0], ast.stmt):
                yield block
        for handler in getattr(stmt, "handlers", []) or []:
            if handler.body:
                yield handler.body

    def _await_before_transition(stmt: ast.stmt) -> Optional[int]:
        """An await that resolves before a transition WITHIN ``stmt``,
        branch-aware: each block of a compound statement is scanned
        independently, so an await in one branch never counts against
        a transition in a mutually-exclusive sibling branch."""
        blocks = list(_stmt_blocks(stmt))
        if not blocks:
            # simple statement: only awaits nested in the transition
            # call's own ARGUMENTS run first (argument evaluation
            # precedes the call regardless of line layout)
            for node in ast.walk(stmt):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "transition"):
                    for arg in list(node.args) + [kw.value for kw
                                                  in node.keywords]:
                        for sub in ast.walk(arg):
                            if isinstance(sub, ast.Await):
                                return sub.lineno
            return None
        for block in blocks:
            pending: Optional[int] = None
            for inner in block:
                if first_transition[id(inner)] is not None:
                    if pending is not None:
                        return pending
                    nested = _await_before_transition(inner)
                    if nested is not None:
                        return nested
                    break  # transition settled this block; later
                    # awaits in it are the blessed cleanup pattern
                if pending is None:
                    pending = first_await[id(inner)]
        return None

    out = []
    for block in _iter_blocks(module):
        for index, stmt in enumerate(block):
            settle_line = _stmt_settle_line(stmt)
            if settle_line is None:
                continue
            pending: Optional[int] = None
            for later in block[index + 1:]:
                if first_transition[id(later)] is not None:
                    if pending is None:
                        pending = _await_before_transition(later)
                    if pending is not None:
                        out.append(Finding(
                            "ack-settle-atomicity", module.rel_path,
                            pending,
                            "await between delivery settle (line "
                            f"{settle_line}) and the terminal "
                            "registry.transition — observers woken by "
                            "the ack see a settled-but-not-terminal "
                            "record; transition first, then await",
                        ))
                    break
                if pending is None:
                    pending = first_await[id(later)]
    return out


# -- unbounded aiohttp timeouts ----------------------------------------

_HTTP_METHOD_ATTRS = frozenset({
    "get", "post", "head", "put", "patch", "delete", "options",
    "request", "ws_connect",
})


def _callable_name(func: ast.expr) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


@module_checker(
    "unbounded-timeout",
    "Explicit timeout=None on an aiohttp session/request call (or "
    "ClientTimeout(total=None)) is UNBOUNDED — not 'session "
    "default'.  Pass a finite ClientTimeout, or omit "
    "the kwarg to inherit the session's.")
def check_unbounded_timeout(module: ModuleSource) -> List[Finding]:
    out = []
    for node in module.nodes:
        if not isinstance(node, ast.Call):
            continue
        name = _callable_name(node.func)
        if name == "ClientTimeout":
            for kw in node.keywords:
                if (kw.arg == "total"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is None):
                    out.append(Finding(
                        "unbounded-timeout", module.rel_path, node.lineno,
                        "ClientTimeout(total=None) never fires — bound "
                        "the request or drop the kwarg"))
            continue
        if name not in _HTTP_METHOD_ATTRS and name != "ClientSession":
            continue
        for kw in node.keywords:
            if (kw.arg == "timeout"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is None):
                out.append(Finding(
                    "unbounded-timeout", module.rel_path, node.lineno,
                    f"timeout=None on {name}() is unbounded in aiohttp "
                    "(not the session default) — a black-holed peer "
                    "hangs the call forever"))
    return out


# -- blocking calls on the event loop ----------------------------------

#: module.attr calls that block the loop; shutil is wildcarded (every
#: public shutil helper is synchronous bulk I/O).
_BLOCKING_MODULE_CALLS = {
    "time": frozenset({"sleep"}),
    "os": frozenset({"walk"}),
    "json": frozenset({"load", "dump"}),
    "shutil": None,  # None = every attr
}


@module_checker(
    "blocking-call-in-async",
    "Synchronous blocking work (time.sleep, open(), os.walk, shutil.*, "
    "json.load/dump on files) called directly inside an async def stalls "
    "the event loop for every job on the worker — the reason "
    "LoopLagMonitor exists.  Route it through asyncio.to_thread / an "
    "executor, or move it to a sync helper the caller offloads.")
def check_blocking_in_async(module: ModuleSource) -> List[Finding]:
    if module.profile != "library":
        # the invariant protects the WORKER's event loop: one stalled
        # loop stalls every job on the replica.  Tests, benches, and
        # CLI tools run private, single-user loops where a blocking
        # metadata touch costs only their own wall clock.
        return []
    out = []
    for node in module.nodes:
        if not isinstance(node, ast.Call):
            continue
        blocked: Optional[str] = None
        func = node.func
        if isinstance(func, ast.Name) and func.id == "open":
            blocked = "open()"
        elif (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id in _BLOCKING_MODULE_CALLS):
            allowed = _BLOCKING_MODULE_CALLS[func.value.id]
            if allowed is None or func.attr in allowed:
                blocked = f"{func.value.id}.{func.attr}()"
        if blocked is None:
            continue
        if not module.in_async_code(node):
            continue
        out.append(Finding(
            "blocking-call-in-async", module.rel_path, node.lineno,
            f"{blocked} blocks the event loop inside an async def — "
            "use asyncio.to_thread / run_in_executor"))
    return out


# -- swallowed cancellation --------------------------------------------

def _catches_base_exception(handler: ast.ExceptHandler) -> bool:
    def is_base(expr: ast.expr) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id == "BaseException"
        if isinstance(expr, ast.Attribute):
            return expr.attr == "BaseException"
        return False

    if handler.type is None:
        return True
    if isinstance(handler.type, ast.Tuple):
        return any(is_base(elt) for elt in handler.type.elts)
    return is_base(handler.type)


def _reraises(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            if node.exc is None:
                return True
            if (isinstance(node.exc, ast.Name)
                    and node.exc.id == handler.name):
                return True
    return False


@module_checker(
    "swallowed-cancellation",
    "except BaseException / bare except inside async code without a "
    "re-raise eats asyncio.CancelledError — cancel tokens, watchdog "
    "task-cancels, and shutdown then hang on a task that will not die. "
    "(except Exception is safe: CancelledError derives from "
    "BaseException on 3.8+.)")
def check_swallowed_cancellation(module: ModuleSource) -> List[Finding]:
    out = []
    for node in module.nodes:
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _catches_base_exception(node):
            continue
        if not module.in_async_code(node):
            continue
        if _reraises(node):
            continue
        out.append(Finding(
            "swallowed-cancellation", module.rel_path, node.lineno,
            "BaseException caught in async code without re-raising — "
            "CancelledError must escape (re-raise, or narrow to "
            "Exception)"))
    return out
