"""Magnet URI parsing (BEP 9 §magnet): ``magnet:?xt=urn:btih:<hash>&dn=...&tr=...``."""

from __future__ import annotations

import base64
import dataclasses
import urllib.parse
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class MagnetLink:
    info_hash: bytes            # 20-byte SHA-1
    display_name: Optional[str]
    trackers: List[str]
    # x.pe direct peer addresses (BEP 9) as (host, port)
    peer_addrs: tuple = ()
    # ws= webseed URLs (BEP 19 via magnet)
    webseeds: tuple = ()

    @property
    def info_hash_hex(self) -> str:
        return self.info_hash.hex()


def parse_magnet(uri: str) -> MagnetLink:
    parsed = urllib.parse.urlparse(uri)
    if parsed.scheme != "magnet":
        raise ValueError(f"not a magnet URI: {uri[:40]!r}")
    params = urllib.parse.parse_qs(parsed.query)

    info_hash: Optional[bytes] = None
    for xt in params.get("xt", []):
        if xt.startswith("urn:btih:"):
            raw = xt[len("urn:btih:"):]
            if len(raw) == 40:  # hex
                info_hash = bytes.fromhex(raw)
            elif len(raw) == 32:  # base32
                info_hash = base64.b32decode(raw.upper())
            else:
                raise ValueError(f"bad btih length {len(raw)}")
            break
    if info_hash is None:
        raise ValueError("magnet URI has no urn:btih exact topic")

    names = params.get("dn", [])
    peer_addrs = []
    for pe in params.get("x.pe", []):
        host, _, port = pe.rpartition(":")
        try:
            port_num = int(port)
        except ValueError:
            continue
        if host.startswith("[") and host.endswith("]"):
            host = host[1:-1]  # bracketed IPv6 literal
        if host and 0 < port_num < 65536:  # unconnectable ports waste a
            peer_addrs.append((host, port_num))  # MAX_PEERS worker slot
    return MagnetLink(
        info_hash=info_hash,
        display_name=names[0] if names else None,
        trackers=params.get("tr", []),
        peer_addrs=tuple(peer_addrs),
        webseeds=tuple(params.get("ws", [])),
    )


def make_magnet(info_hash: bytes, name: Optional[str] = None,
                trackers: Optional[List[str]] = None) -> str:
    parts = [f"xt=urn:btih:{info_hash.hex()}"]
    if name:
        parts.append("dn=" + urllib.parse.quote(name, safe=""))
    for tracker in trackers or []:
        parts.append("tr=" + urllib.parse.quote(tracker, safe=""))
    return "magnet:?" + "&".join(parts)
