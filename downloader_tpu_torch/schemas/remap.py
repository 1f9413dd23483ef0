"""Config-driven field-number remapping at the protobuf wire level.

The reference decodes ``api.Download`` / publishes ``api.Convert`` using
triton-core's schema registry (upstream lib/main.js:55-56,163-164).
That package is an npm dependency that is not vendored in the reference
tree, so the field NUMBERS of the real deployment cannot be compared
offline — our schema freezes its own numbers with golden bytes
(tests/test_wire_freeze.py).  If a real deployment's numbers turn out to
differ, this module makes reconciliation a config change instead of a
schema migration: a table like

    wire_remap:
      Media:    {id: 3, creator_id: 1}
      Download: {created_at: 9}

declares, per message type, the DEPLOYMENT's wire number for each of our
field names.  Encoding rewrites our numbers to theirs; decoding rewrites
theirs back to ours.  The rewrite happens on the serialized bytes (one
pass over the tag/value tokens), so the generated classes stay the
single source of truth for field names and no code is regenerated:

- field numbers not mentioned in the table pass through unchanged, so
  unknown fields keep their unknown-field-preservation behavior;
- message-typed fields recurse with their own message's table;
- the mapping must be injective per message (checked at build time).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from google.protobuf.descriptor import Descriptor, FieldDescriptor

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5

# plan: src wire number -> (dst wire number, nested plan | None)
Plan = Dict[int, Tuple[int, Optional[dict]]]


class RemapError(ValueError):
    pass


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if i >= len(data):
            raise RemapError("truncated varint")
        byte = data[i]
        i += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, i
        shift += 7
        if shift > 63:
            raise RemapError("varint too long")


def _append_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def build_plan(descriptor: Descriptor, tables: dict,
               reverse: bool = False) -> Plan:
    """Compile a remap plan for one message type from the config table.

    ``tables`` maps message simple names to ``{field_name: their_number}``.
    ``reverse=True`` builds the decode-direction plan (their -> ours).
    """
    table = dict(tables.get(descriptor.name) or {})
    plan: Plan = {}
    seen_dst: Dict[int, str] = {}
    for field in descriptor.fields:
        theirs = int(table.pop(field.name, field.number))
        if theirs in seen_dst:
            raise RemapError(
                f"{descriptor.name}: fields {seen_dst[theirs]!r} and "
                f"{field.name!r} both map to wire number {theirs}"
            )
        seen_dst[theirs] = field.name
        sub: Optional[Plan] = None
        if field.type == FieldDescriptor.TYPE_MESSAGE:
            sub = build_plan(field.message_type, tables, reverse=reverse)
        if theirs != field.number or sub:
            if reverse:
                plan[theirs] = (field.number, sub)
            else:
                plan[field.number] = (theirs, sub)
    if table:
        raise RemapError(
            f"{descriptor.name}: unknown field(s) in wire_remap: "
            f"{sorted(table)}"
        )
    return plan


def transcode(data: bytes, plan: Plan) -> bytes:
    """Rewrite field numbers in serialized protobuf bytes per ``plan``.

    Unmapped numbers pass through byte-identical (including unknown
    fields).  Groups (wire types 3/4) are legacy proto2 and rejected.
    """
    if not plan:
        return data
    # unknown (pass-through) numbers must not land on a remap target:
    # two same-numbered fields would last-wins-merge in the parser,
    # silently corrupting the mapped field AND swallowing the unknown
    taken = {dst for dst, _sub in plan.values()}
    out = bytearray()
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire_type = key >> 3, key & 7
        dst, sub = plan.get(field, (field, None))
        if field not in plan and field in taken:
            raise RemapError(
                f"unmapped field number {field} collides with a remap "
                f"destination; extend the wire_remap table to cover it"
            )
        _append_varint(out, (dst << 3) | wire_type)
        if wire_type == _WT_VARINT:
            value, i = _read_varint(data, i)
            _append_varint(out, value)
        elif wire_type == _WT_I64:
            out += data[i:i + 8]
            i += 8
        elif wire_type == _WT_I32:
            out += data[i:i + 4]
            i += 4
        elif wire_type == _WT_LEN:
            length, i = _read_varint(data, i)
            if i + length > len(data):
                raise RemapError("truncated length-delimited field")
            chunk = data[i:i + length]
            i += length
            if sub:
                chunk = transcode(chunk, sub)
            _append_varint(out, len(chunk))
            out += chunk
        else:
            raise RemapError(f"unsupported wire type {wire_type}")
    return bytes(out)


class WireRemap:
    """Per-message-type encode/decode plans compiled from a config table."""

    def __init__(self, tables: dict):
        self._tables = dict(tables)
        self._plans: Dict[Tuple[str, bool], Plan] = {}

    def _plan(self, descriptor: Descriptor, reverse: bool) -> Plan:
        key = (descriptor.full_name, reverse)
        if key not in self._plans:
            self._plans[key] = build_plan(
                descriptor, self._tables, reverse=reverse)
        return self._plans[key]

    def to_wire(self, descriptor: Descriptor, data: bytes) -> bytes:
        """Ours -> deployment numbering (encode direction)."""
        return transcode(data, self._plan(descriptor, reverse=False))

    def from_wire(self, descriptor: Descriptor, data: bytes) -> bytes:
        """Deployment -> our numbering (decode direction)."""
        return transcode(data, self._plan(descriptor, reverse=True))
