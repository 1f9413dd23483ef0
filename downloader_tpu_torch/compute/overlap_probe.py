"""Paced-source overlap probe for :meth:`FrameUpscaler.upscale_to` — a
copy of ``downloader_tpu/compute/overlap_probe.py``, on the port's
``video``; ``tests/test_torch_service_copies.py`` holds it to the
reference's code.

The drill: feed the engine a Y4M source that blocks a fixed interval
per frame (a rate-limited decoder pipe), measure wall time for the
serial lower bound (depth=1 — drain after every dispatch) vs the
pipelined path (depth=3), plus pure-IO and pure-compute references.
``overlap = (serial - pipelined) / min(io, compute)`` is the fraction
of the hideable time actually hidden: ~0 means dispatch/fetch
serialize; >= ~0.9 means the in-flight queue works.  On the CPU the
port's engine computes at dispatch, so only the card's engine can
overlap.
"""

from __future__ import annotations

import io
import os
import time
from typing import Optional

import numpy as np

from .video import Y4MHeader, Y4MWriter


def measure_overlap(
    engine,
    height: int = 96,
    width: int = 160,
    batches: int = 12,
    frame_interval: float = 0.0125,
    rng: Optional[np.random.Generator] = None,
) -> dict:
    """Run the drill on ``engine`` (already constructed, any backend).

    Returns ``{io_s, compute_s, serial_s, pipelined_s, overlap}``.
    The engine's compile happens inside (one warmup batch) so none of
    the timings include tracing.
    """
    rng = rng or np.random.default_rng(0)
    per_batch = engine.batch
    frames = [
        (rng.integers(0, 256, (height, width), np.uint8),
         rng.integers(0, 256, (height // 2, width // 2), np.uint8),
         rng.integers(0, 256, (height // 2, width // 2), np.uint8))
        for _ in range(per_batch)
    ]
    y = np.stack([f[0] for f in frames])
    cb = np.stack([f[1] for f in frames])
    cr = np.stack([f[2] for f in frames])
    engine.upscale_batch(y, cb, cr, 2, 2)  # compile outside the timings

    start = time.monotonic()
    for _ in range(batches):
        engine.upscale_batch(y, cb, cr, 2, 2)
    compute_s = time.monotonic() - start

    buf = io.BytesIO()
    writer = Y4MWriter(buf, Y4MHeader(width=width, height=height))
    for i in range(batches * per_batch):
        writer.write_frame(*frames[i % per_batch])
    data = buf.getvalue()

    class PacedSource:
        """Y4M source that blocks like a rate-limited decoder pipe."""

        def __init__(self):
            self._buf = io.BytesIO(data)

        def readline(self, n=-1):
            return self._buf.readline(n)

        def read(self, n=-1):
            time.sleep(frame_interval)
            return self._buf.read(n)

    walls = {}
    for depth in (1, 3):  # 1 = drain-after-every-dispatch serial bound
        with open(os.devnull, "wb") as sink:
            start = time.monotonic()
            n = engine.upscale_to(PacedSource(), sink, depth=depth)
        walls[depth] = time.monotonic() - start
        assert n == batches * per_batch, (n, batches * per_batch)

    io_s = batches * per_batch * frame_interval
    return {
        "io_s": io_s,
        "compute_s": compute_s,
        "serial_s": walls[1],
        "pipelined_s": walls[3],
        "overlap": (walls[1] - walls[3]) / min(io_s, compute_s),
    }
