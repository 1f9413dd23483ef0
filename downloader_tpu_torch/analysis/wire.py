"""proto-additive-only: the wire schema may only grow, never mutate.

The queues are consumed by mixed-version replicas (and, per PARITY.md,
by a foreign triton-core fleet), so ``schemas/downloader.proto`` is
additive-only: a field number, once shipped, is burned forever — it
may never be renumbered, retyped, relabeled, or reused by a different
name.  tests/test_wire_freeze.py proves this dynamically against the
*generated* module; this checker proves it statically against the
``.proto`` source, so a bad edit fails ``make lint`` before anyone
regenerates or publishes a byte.

:data:`FROZEN_MESSAGES` / :data:`FROZEN_ENUMS` is the wire high-water
mark: every field shipped so far.  Extending a message is legal
only at numbers ABOVE its frozen maximum (numbers at or below it are
all accounted for — a "new" field down there is a reuse).  A change
that deliberately adds fields must extend these tables in the same
commit (mirroring the test_wire_freeze.py row it also adds).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from .core import Finding, RepoContext, repo_checker

# (type, label, number) per field; label is "" or "repeated"/"optional"
FROZEN_MESSAGES: Dict[str, Dict[str, Tuple[str, str, int]]] = {
    "Media": {
        "id": ("string", "", 1),
        "creator_id": ("string", "", 2),
        "name": ("string", "", 3),
        "type": ("MediaType", "", 4),
        "source": ("SourceType", "", 5),
        "source_uri": ("string", "", 6),
    },
    "Download": {
        "media": ("Media", "", 1),
        "created_at": ("string", "", 2),
        "priority": ("JobPriority", "", 3),
        "tenant": ("string", "", 4),
        "ttl_seconds": ("double", "", 5),
        "mirrors": ("string", "repeated", 6),
        "source_kind": ("SourceKind", "", 7),
    },
    "Convert": {
        "created_at": ("string", "", 1),
        "media": ("Media", "", 2),
        "deadline_seconds": ("double", "", 3),
    },
    "TelemetryStatusEvent": {
        "media_id": ("string", "", 1),
        "status": ("TelemetryStatus", "", 2),
    },
    "TelemetryProgressEvent": {
        "media_id": ("string", "", 1),
        "status": ("TelemetryStatus", "", 2),
        "percent": ("int32", "", 3),
    },
}

FROZEN_ENUMS: Dict[str, Dict[str, int]] = {
    "SourceType": {"TORRENT": 0, "HTTP": 1, "FILE": 2, "BUCKET": 3},
    "MediaType": {"TV": 0, "MOVIE": 1},
    "TelemetryStatus": {
        "CREATED": 0, "QUEUED": 1, "DOWNLOADING": 2, "CONVERTING": 3,
        "UPLOADING": 4, "DEPLOYED": 5, "ERRORED": 6, "CANCELLED": 7,
    },
    "JobPriority": {"NORMAL": 0, "HIGH": 1, "BULK": 2},
    "SourceKind": {"AUTO": 0, "DIRECT": 1, "MANIFEST": 2},
}

_BLOCK_RE = re.compile(r"^\s*(message|enum)\s+(\w+)\s*\{", re.MULTILINE)
_FIELD_RE = re.compile(
    r"^\s*(?:(repeated|optional)\s+)?([\w.]+)\s+(\w+)\s*=\s*(\d+)\s*;")
_ENUM_VALUE_RE = re.compile(r"^\s*(\w+)\s*=\s*(\d+)\s*;")


def parse_proto(text: str):
    """Line parser good for the subset of proto3 this repo writes:
    top-level messages/enums with scalar/message fields.  Returns
    (messages, enums, line map) where line maps ``(block, name)`` to
    the source line of each field/value."""
    messages: Dict[str, Dict[str, Tuple[str, str, int]]] = {}
    enums: Dict[str, Dict[str, int]] = {}
    lines_of: Dict[Tuple[str, str], int] = {}
    current: Tuple[str, str] = ("", "")
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.split("//", 1)[0]
        block = _BLOCK_RE.match(line)
        if block is not None:
            current = (block.group(1), block.group(2))
            if block.group(1) == "message":
                messages.setdefault(block.group(2), {})
            else:
                enums.setdefault(block.group(2), {})
            lines_of[current] = lineno
            continue
        if line.strip().startswith("}"):
            current = ("", "")
            continue
        kind, name = current
        if kind == "message":
            field = _FIELD_RE.match(line)
            if field is not None:
                label, ftype, fname, number = field.groups()
                messages[name][fname] = (ftype, label or "", int(number))
                lines_of[(name, fname)] = lineno
        elif kind == "enum":
            value = _ENUM_VALUE_RE.match(line)
            if value is not None:
                enums[name][value.group(1)] = int(value.group(2))
                lines_of[(name, value.group(1))] = lineno
    return messages, enums, lines_of


@repo_checker(
    "proto-freeze",
    "schemas/downloader.proto is additive-only: frozen fields keep "
    "name/type/label/number forever; new fields only above each "
    "message's frozen high-water number.  Extend wire.FROZEN_MESSAGES "
    "(and tests/test_wire_freeze.py) in the same commit as any "
    "deliberate addition.")
def check_proto_freeze(ctx: RepoContext) -> List[Finding]:
    if not ctx.proto_text:
        return []
    out: List[Finding] = []
    path = ctx.proto_path
    messages, enums, lines_of = parse_proto(ctx.proto_text)

    def flag(anchor: Tuple[str, str], message: str):
        out.append(Finding("proto-freeze", path,
                           lines_of.get(anchor, 1), message))

    for mname, frozen_fields in FROZEN_MESSAGES.items():
        actual = messages.get(mname)
        if actual is None:
            out.append(Finding(
                "proto-freeze", path, 1,
                f"frozen message {mname} deleted from the schema"))
            continue
        high_water = max(num for _, _, num in frozen_fields.values())
        for fname, (ftype, label, number) in frozen_fields.items():
            got = actual.get(fname)
            if got is None:
                flag(("message", mname),
                     f"frozen field {mname}.{fname} (= {number}) "
                     "removed — numbers are burned, never freed")
            elif got != (ftype, label, number):
                flag((mname, fname),
                     f"frozen field {mname}.{fname} changed: "
                     f"{got[1] or 'singular'} {got[0]} = {got[2]} vs "
                     f"frozen {label or 'singular'} {ftype} = {number}")
        numbers: Dict[int, str] = {}
        for fname, (ftype, label, number) in actual.items():
            if fname in frozen_fields:
                numbers[number] = fname
                continue
            if number <= high_water:
                flag((mname, fname),
                     f"new field {mname}.{fname} reuses number "
                     f"{number} at or below the frozen high-water mark "
                     f"({high_water}) — that number belonged to "
                     "another field on deployed wires")
            if number in numbers:
                flag((mname, fname),
                     f"{mname}.{fname} duplicates field number "
                     f"{number} (also {numbers[number]})")
            numbers[number] = fname

    for ename, frozen_values in FROZEN_ENUMS.items():
        actual_values = enums.get(ename)
        if actual_values is None:
            out.append(Finding(
                "proto-freeze", path, 1,
                f"frozen enum {ename} deleted from the schema"))
            continue
        high_water = max(frozen_values.values())
        for vname, number in frozen_values.items():
            got = actual_values.get(vname)
            if got is None:
                flag(("enum", ename),
                     f"frozen enum value {ename}.{vname} (= {number}) "
                     "removed")
            elif got != number:
                flag((ename, vname),
                     f"frozen enum value {ename}.{vname} renumbered "
                     f"{number} -> {got}")
        for vname, number in actual_values.items():
            if vname not in frozen_values and number <= high_water:
                flag((ename, vname),
                     f"new enum value {ename}.{vname} reuses number "
                     f"{number} at or below the frozen high-water mark "
                     f"({high_water})")
    return out
