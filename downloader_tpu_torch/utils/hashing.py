"""Shared file-hashing helpers.

Both the upload stage's resume probe and the filesystem store's etag
computation must produce identical digests — the resume check compares
one against the other — so they share this single implementation.
"""

from __future__ import annotations

import hashlib

_CHUNK = 1 << 20  # 1 MiB


def md5_file_hex(path: str) -> str:
    """Chunked MD5 of a file, as the lowercase hex S3-style etag."""
    digest = hashlib.md5()
    with open(path, "rb") as fh:
        while chunk := fh.read(_CHUNK):
            digest.update(chunk)
    return digest.hexdigest()


def multipart_etag_hex(path: str, part_size: int) -> str:
    """The S3 multipart ETag for a file at a given part size:
    ``md5(concat(md5(part_i)))-N`` — verifiable locally, so the upload
    stage's resume guard works for multipart objects too."""
    digests = []
    with open(path, "rb") as fh:
        while True:
            part = hashlib.md5()
            remaining = part_size
            got = 0
            while remaining > 0:
                chunk = fh.read(min(_CHUNK, remaining))
                if not chunk:
                    break
                part.update(chunk)
                got += len(chunk)
                remaining -= len(chunk)
            if got == 0:
                break
            digests.append(part.digest())
    combined = hashlib.md5(b"".join(digests)).hexdigest()
    return f"{combined}-{len(digests)}"
