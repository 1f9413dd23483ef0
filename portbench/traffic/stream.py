"""Traffic driver ``stream``: one endless Y4M stream through
``FrameUpscaler.upscale_to``, the path of the ``upscale`` CLI and stage.

Parameters (the traffic's file): ``width``, ``height`` (4:2:0 input),
``pool`` (seeded frames served from memory in a cycle), ``depth`` (the
engine's transfer-queue depth), ``warm_batches`` (batches before the
window opens) and ``sample_per_row`` (window frames checked against the
reference at each row of the batch).  The engine batch and the mesh come from the configuration.

The window opens when the last warm-up frame's last byte reaches the
sink, so the queue is full and every shape has run; it closes
``seconds`` later.  The source then ends the stream at the next batch
boundary (no short batch), and the drain is not counted.  A frame's
latency runs from the engine reading its bytes from the source to its
last output byte reaching the sink.  The sink drops the bytes, except
for a seeded sample of the window's frames at every row of the batch,
which the plain reference recomputes once the program's state is freed.
"""

from __future__ import annotations

import gc
import random
import time
from typing import List, Optional

import numpy as np
import torch

from portbench import seeded
from portbench.harness import Check, Outcome
from portbench.reference import upscaler as reference

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def header(width: int, height: int) -> bytes:
    return f"YUV4MPEG2 W{width} H{height} F30:1 Ip A1:1 C420jpeg\n".encode()


class Source:
    """A readable Y4M stream: the header, then the pool's frames in a
    cycle, ending at a batch boundary once ``close_at`` has passed."""

    def __init__(self, head: bytes, pool: List[bytes], batch: int, tracer):
        self._head: Optional[bytes] = head
        self._pool = pool
        self._batch = batch
        self._tracer = tracer
        self.close_at: Optional[float] = None
        self.read_at: List[float] = []

    def readline(self, limit: int = -1) -> bytes:
        if self._head is not None:
            head, self._head = self._head, None
            return head
        if (self.close_at is not None and len(self.read_at) % self._batch == 0
                and time.monotonic() >= self.close_at):
            return b""
        return b"FRAME\n"

    def read(self, size: int) -> bytes:
        with self._tracer.span("host.source_read"):
            data = self._pool[len(self.read_at) % len(self._pool)]
            if size != len(data):
                raise ValueError(f"read of {size} bytes, frames hold {len(data)}")
            self.read_at.append(time.monotonic())
            return data


class Sink:
    """A writable that checks the stream's framing, times each frame's
    last byte, opens and closes the window, and keeps a seeded sample of
    the window's frames; all other bytes are dropped."""

    def __init__(self, ctx, head: bytes, plane_bytes, warm_frames: int,
                 source: Source, batch: int, per_row: int):
        self.ctx = ctx
        self._head = head
        self._sizes = plane_bytes
        self._warm = warm_frames
        self._source = source
        self._batch = batch
        self._per_row = per_row
        self._seen = [0] * batch
        self._rows: list = [[] for _ in range(batch)]
        self._rng = random.Random(ctx.seed)
        self._part = -1          # -1 header, 0 marker, 1..3 planes
        self._planes: list = []
        self.malformed = 0
        self.done = 0            # frames whose last byte arrived
        self.opened: Optional[float] = None
        self.closed: Optional[float] = None
        self.latencies: List[float] = []
        self.in_window = 0

    def write(self, data) -> int:
        with self.ctx.tracer.span("host.sink_write"):
            now = time.monotonic()
            if self.closed is None and self.opened is not None and now > self.closed_at:
                self.closed = self.closed_at
                self.ctx.tracer.close()
            if self._part == -1:
                self.malformed += bytes(data) != self._head
            elif self._part == 0:
                self.malformed += bytes(data) != b"FRAME\n"
                self._planes = []
            else:
                self.malformed += len(data) != self._sizes[self._part - 1]
                self._planes.append(data)
                if self._part == 3:
                    self._frame_done(now)
            self._part = 0 if self._part == 3 else self._part + 1
        return len(data)

    def _frame_done(self, now: float) -> None:
        index = self.done
        self.done += 1
        if index == self._warm - 1:
            self.opened = now
            self.closed_at = now + self.ctx.seconds
            self._source.close_at = self.closed_at
            self.ctx.window_open = now
            self.ctx.mark("warm-up")
            self.ctx.tracer.open()
        elif self.opened is not None and now <= self.closed_at:
            self.latencies.append(now - self._source.read_at[index])
            self.in_window += 1
            row = index % self._batch
            kept, seen = self._rows[row], self._seen[row]
            self._seen[row] += 1
            if seen < self._per_row:
                kept.append((index, tuple(self._planes)))
            else:
                j = self._rng.randrange(seen + 1)
                if j < self._per_row:
                    kept[j] = (index, tuple(self._planes))

    @property
    def sample(self) -> list:
        """(frame index, (y, cb, cr) bytes) of the kept frames: at every
        row of the batch, ``per_row`` of the window's frames drawn
        uniformly from the seed, so that every row of every shard is
        checked."""
        return sorted(item for kept in self._rows for item in kept)


def model_config(config: dict):
    from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig

    return UpscalerConfig(scale=config["scale"], features=config["features"],
                          depth=config["depth"], channels=config["channels"],
                          param_dtype=_DTYPES[config["param_dtype"]],
                          compute_dtype=_DTYPES[config["compute_dtype"]])


class _Traced:
    """The traced run's wrappers around the engine's calls: host spans,
    CUDA events around each ``_core`` call, and the engine's hop notes."""

    def __init__(self, ctx, engine):
        from downloader_tpu_torch.compute import pipeline

        self.ctx, self.engine, self.pipeline = ctx, engine, pipeline
        self.hops: list = []     # (time, hop, seconds)
        self.cores: list = []    # (time, device, start event, end event)
        self._batched = pipeline._batched
        span = ctx.tracer.span
        core, dispatch, fetch = engine._core, engine._dispatch, engine._fetch
        batched = self._batched

        def traced_core(*args):
            if args[0].device.type != "cuda":
                return core(*args)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = core(*args)
            end.record()
            self.cores.append((time.monotonic(), args[0].device.index, start, end))
            return out

        def traced_dispatch(*args):
            with span("host.dispatch"):
                return dispatch(*args)

        def traced_fetch(handle):
            with span("host.fetch"):
                return fetch(handle)

        def traced_batched(frames, batch):
            it = batched(frames, batch)
            while True:
                with span("host.batching"):
                    item = next(it, None)
                if item is None:
                    return
                yield item

        engine._core, engine._dispatch, engine._fetch = traced_core, traced_dispatch, traced_fetch
        pipeline._batched = traced_batched

    def note(self, hop: str, nbytes: int, seconds: float) -> None:
        self.hops.append((time.monotonic(), hop, seconds))

    def restore(self) -> None:
        self.pipeline._batched = self._batched
        for name in ("_core", "_dispatch", "_fetch"):
            delattr(self.engine, name)

    def readings(self, opened: float, closed: float) -> dict:
        """Hop seconds and per-dispatch device ms inside the window."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        hops = [(hop, s) for t, hop, s in self.hops if opened < t <= closed]
        per_dispatch: dict = {}
        n_dev = max(1, self.ctx.chips)
        for i, (t, _dev, start, end) in enumerate(self.cores):
            if opened < t <= closed:
                key = i // n_dev
                per_dispatch[key] = max(per_dispatch.get(key, 0.0), start.elapsed_time(end))
        return {"hops": hops, "core_ms": list(per_dispatch.values())}


def _planes_of(data, y_shape, c_shape):
    y, cb, cr = data
    return (np.frombuffer(y, np.uint8).reshape(y_shape),
            np.frombuffer(cb, np.uint8).reshape(c_shape),
            np.frombuffer(cr, np.uint8).reshape(c_shape))


def compare(got, want) -> dict:
    """Per-plane gaps of a frame's u8 planes against the reference's: the
    mean absolute step and the largest step, each the worst of the three
    planes."""
    gaps = {"worst_mae": 0.0, "worst_step": 0.0}
    for g, w in zip(got, want):
        d = np.abs(g.astype(np.int16) - w.astype(np.int16))
        gaps["worst_mae"] = max(gaps["worst_mae"], float(d.mean()))
        gaps["worst_step"] = max(gaps["worst_step"], float(d.max()))
    return gaps


def judge(ctx, weights, pool, sample, precision=None, detail=None) -> dict:
    """The worst gaps over the sampled frames between what was produced
    and the plain reference (``precision="fp8"``: the control's output in
    the program's place); ``detail`` (a list) receives each frame's gaps
    and its share of clipped reference values."""
    config, traffic = ctx.config, ctx.traffic
    h, w, r = traffic["height"], traffic["width"], config["scale"]
    y_shape, c_shape = (h * r, w * r), (h * r // 2, w * r // 2)
    worst = {"worst_mae": 0.0, "worst_step": 0.0}
    for index, data in sample:
        planes = [p[index % len(pool[0])][None].to(ctx.device) for p in pool]
        want = [p[0].cpu().numpy() for p in reference.upscale(
            weights, *planes, r, config["depth"])]
        if precision is None:
            got = _planes_of(data, y_shape, c_shape)
        else:
            got = [p[0].cpu().numpy() for p in reference.upscale(
                weights, *planes, r, config["depth"], precision)]
        gaps = compare(got, want)
        for key, value in gaps.items():
            worst[key] = max(worst[key], value)
        if detail is not None:
            clipped = float(np.mean([((p == 0) | (p == 255)).mean() for p in want]))
            detail.append(dict(gaps, frame=index, clipped=clipped))
    return worst


def peak_memory(ctx) -> int:
    if ctx.device != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count()))


def run(ctx) -> Outcome:
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler

    config, traffic = ctx.config, ctx.traffic
    h, w, r = traffic["height"], traffic["width"], config["scale"]
    ctx.mark("imports")
    weights = seeded.weights(config, ctx.seed, ctx.device)
    pool = seeded.frames(traffic["pool"], h, w, 2, ctx.seed + 1, ctx.device)
    pool_host = [p.cpu().numpy() for p in pool]
    frames = [b"".join(p[i].tobytes() for p in pool_host) for i in range(traffic["pool"])]
    ctx.mark("inputs")
    engine = FrameUpscaler(model_config(config), batch=config["batch"], params=weights,
                           device=ctx.device, use_mesh=config["use_mesh"])
    ctx.mark("engine")
    batch = engine.batch_for(h, w)
    source = Source(header(w, h), frames, batch, ctx.tracer)
    out_head = header(w * r, h * r)
    sizes = (h * r * w * r, h * r * w * r // 4, h * r * w * r // 4)
    sink = Sink(ctx, out_head, sizes, traffic["warm_batches"] * batch, source,
                batch, traffic["sample_per_row"])
    traced = _Traced(ctx, engine) if ctx.trace else None
    ctx.tracer.start()
    try:
        if traced is not None:
            with engine.hop_sink.bound(traced.note):
                engine.upscale_to(source, sink, depth=traffic["depth"])
        else:
            engine.upscale_to(source, sink, depth=traffic["depth"])
        if sink.closed is None:
            sink.closed = sink.closed_at
        readings = {} if traced is None else traced.readings(sink.opened, sink.closed)
    finally:
        ctx.tracer.stop()
        if traced is not None:
            traced.restore()
    if not sink.latencies:
        raise RuntimeError("the window wrote no frame")
    window = sink.closed - sink.opened
    frames_lost = len(source.read_at) - sink.done
    peak = peak_memory(ctx)
    del engine, traced
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    sample = sink.sample
    detail: list = []
    gaps = judge(ctx, weights, pool, sample, detail=detail)
    readings["compare_detail"] = detail
    checks = [Check("frames_lost", float(frames_lost), ctx.limits["frames_lost"]),
              Check("stream_malformed", float(sink.malformed), ctx.limits["stream_malformed"]),
              Check("sample_short", float(batch * traffic["sample_per_row"] - len(sample)),
                    ctx.limits["sample_short"])]
    checks += [Check(k, v, ctx.limits[k]) for k, v in gaps.items()]
    readings.update(frames=sink.in_window, window_s=window, batch=batch)
    return Outcome(
        metrics={"frames_per_s": (sink.in_window / window, "frames/s"),
                 "frame_latency_p95_ms": (1e3 * p95(sink.latencies), "ms")},
        attempted=len(source.read_at), failed=frames_lost + sink.malformed,
        checks=checks, memory_peak_bytes=peak, readings=readings,
        control=lambda precision: judge(ctx, weights, pool, sample, precision))


def p95(values: List[float]) -> float:
    """The 95th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values), 95))
