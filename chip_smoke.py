#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``downloader_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) on any error:

1. device: the card's name and power limit; build every CUDA kernel of
   ``downloader_tpu_torch/compute/csrc`` with ``nvcc`` (timed);
2. ``quantize_u8`` (standalone): kernel vs its plain PyTorch version on
   the card, byte-exact, over f32/bf16, out-of-range values, exact .5
   ties, a ragged and a misaligned input, and the reference's quantize
   shapes; timed.  It is off this slice's main path, whose three
   quantizes run inline in the tail kernel;
3. ``fused_subpixel_ycc_s2d``: kernel vs plain on the card, byte-exact,
   on a seeded (8, 540, 960, 48) bf16 packed head output; timed;
4. main path: a seeded 16-frame 1920x1080 4:2:0 Y4M through the port's
   ``upscale`` CLI at the model's full width (``python -m
   downloader_tpu_torch upscale`` in a subprocess, then the CLI's
   ``main()`` in-process with every kernel launch counter set to 0 just
   before and read just after); the output must be a 3840x2160 stream
   of 16 frames, every kernel of the path must have launched, the tail
   kernel must match the plain tail byte for byte on the engine's own
   packed output, and the card must agree with the CPU's plain path on
   a small input;
5. throughput at 720p and 1080p: ``FrameUpscaler.upscale_to`` (the
   CLI's streaming path) over a 256-frame Y4M stream in memory into a
   sink that drops the bytes, after a warm-up stream that fills the
   transfer queue; frames/s over 3 runs with their spread, the share of
   the wall the card spends computing (CUDA events around each batch's
   compute), a per-stage device split, peak memory and the host's
   h2d/compute/d2h waits.

It prints the card line (``nvidia-smi --query-gpu=name,power.limit``),
then one JSON line with every kernel's numbers, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run from a
directory that does not hold the port, it exits non-zero and prints no
result.  Bounds are data-sheet figures picked by the card's name.
"""

from __future__ import annotations

import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# data-sheet memory bandwidth (bytes/s) and non-tensor f32 rate (FLOP/s),
# by a substring of the card's name; first match wins (the SXM part
# reports no form factor in its name)
_CARDS = [
    ("H100 PCIe", 2.0e12, 51e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),
]

FRAMES, WIDTH, HEIGHT = 16, 1920, 1080
STREAM_BATCHES, RUNS = 32, 3  # throughput: batches per timed stream, runs


def _say(msg: str) -> None:
    print(msg, flush=True)


def _card_rates(name: str):
    for tag, bandwidth, f32_rate in _CARDS:
        if tag in name:
            return bandwidth, f32_rate
    raise RuntimeError(f"no data-sheet rates for card {name!r}")


def _bound_ms(nbytes: int, ops: int, rates) -> tuple:
    bandwidth, f32_rate = rates
    t_bytes, t_ops = nbytes / bandwidth, ops / f32_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _time_ms(torch, fn, reps: int = 25) -> float:
    """Median device time of one call, from CUDA events around each of
    ``reps`` back-to-back calls queued behind a sleep kernel, so host
    overhead between calls does not leave the card idle."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _assert_equal(got, want, what: str) -> int:
    """Require byte equality; return the max abs difference (0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(want.shape)}/{want.dtype}")
    diff = (got.int() - want.int()).abs()
    bad = int((diff != 0).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} of {got.numel()} bytes differ, "
                             f"max {int(diff.max())} steps")
    return int(diff.max()) if diff.numel() else 0


def _quantize_cases(torch, gen, dev):
    """(label, tensor) pairs: ties, out-of-range, ragged, misaligned and
    the main path's shapes, f32 and bf16."""
    edge = torch.rand((3, 5, 7, 13), generator=gen, device=dev) * 340 - 40
    ties = torch.randint(-3, 258, edge.shape, generator=gen, device=dev) + 0.5
    mask = torch.rand(edge.shape, generator=gen, device=dev) < 0.3
    edge = torch.where(mask, ties, edge)
    edge.view(-1)[:6] = torch.tensor([0.5, 1.5, 2.5, 254.5, 255.5, -0.5], device=dev)
    cases = [("ragged f32", edge), ("ragged bf16", edge.bfloat16()),
             ("misaligned f32", edge.view(-1)[1:]),
             ("misaligned bf16", edge.bfloat16().view(-1)[1:])]
    b, hh, ww = 8, HEIGHT // 2, WIDTH // 2
    for label, shape in (("y_sub", (b, hh, ww, 4, 4)), ("cb", (b, hh, ww, 4))):
        x = torch.randn(shape, generator=gen, device=dev) * 80 + 128
        cases.append((f"{label} {tuple(shape)} f32", x))
    return cases


def phase_quantize(torch, rates):
    from downloader_tpu_torch.compute.ops.pixel_shuffle import (
        quantize_u8,
        quantize_u8_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, x in _quantize_cases(torch, gen, dev):
        got = quantize_u8(x)
        torch.cuda.synchronize()
        _assert_equal(got, quantize_u8_plain(x), f"quantize_u8 {label}")
        _say(f"quantize_u8 {label}: byte-exact vs plain ({x.numel()} values)")
        if label.startswith(("y_sub", "cb")):
            ms = _time_ms(torch, lambda: quantize_u8(x))
            plain_ms = _time_ms(torch, lambda: quantize_u8_plain(x))
            nbytes = x.numel() * (x.element_size() + 1)
            bound, by = _bound_ms(nbytes, 3 * x.numel(), rates)
            _say(f"quantize_u8 {label}: kernel {ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}, "
                 f"{nbytes / 1e6:.1f} MB)")


def _packed_input(torch, shape, gen, dev, wide=False):
    if wide:  # exponents spread so any other operation order rounds differently
        mant = torch.rand(shape, generator=gen, device=dev) * 3 - 1.5
        exp = torch.randint(-20, 3, shape, generator=gen, device=dev).float()
        return (mant * torch.exp2(exp)).bfloat16()
    return (torch.randn(shape, generator=gen, device=dev) * 0.6 + 0.3).bfloat16()


def phase_tail(torch, rates, results):
    from downloader_tpu_torch.compute.ops.colorspace import (
        fused_subpixel_ycc_s2d,
        fused_subpixel_ycc_s2d_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    shape = (8, HEIGHT // 2, WIDTH // 2, 48)
    err = 0
    for label, packed in (("wide-exponent (2,10,12,48)",
                           _packed_input(torch, (2, 10, 12, 48), gen, dev, True)),
                          (f"{shape}", _packed_input(torch, shape, gen, dev))):
        got = fused_subpixel_ycc_s2d(packed, 2)
        torch.cuda.synchronize()
        for plane, g, w in zip("y cb cr".split(), got,
                               fused_subpixel_ycc_s2d_plain(packed, 2)):
            err = max(err, _assert_equal(g, w, f"s2d tail {label} {plane}"))
        _say(f"fused_subpixel_ycc_s2d {label}: byte-exact vs plain "
             f"(y {tuple(got[0].shape)}, cb/cr {tuple(got[1].shape)})")
    ms = _time_ms(torch, lambda: fused_subpixel_ycc_s2d(packed, 2))
    plain_ms = _time_ms(torch, lambda: fused_subpixel_ycc_s2d_plain(packed, 2),
                        reps=20)
    pixels = packed.numel() // 12  # one chroma pixel per 12 packed values
    nbytes = packed.numel() * 2 + sum(t.numel() for t in got)
    # per chroma pixel: 4 luma contractions (5 flops), the 3-channel mean
    # (4 each) and 2 chroma contractions + offset (6 each)
    bound, by = _bound_ms(nbytes, 44 * pixels, rates)
    results["fused_subpixel_ycc_s2d"] = dict(ms=ms, plain_ms=plain_ms,
                                             bound_ms=bound, bound_by=by,
                                             max_abs_err=err)
    _say(f"fused_subpixel_ycc_s2d {shape}: kernel {ms:.4f} ms, "
         f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}, "
         f"{nbytes / 1e6:.1f} MB)")


def _write_y4m(fh, frames: int, width: int, height: int, seed: int,
               distinct: int = 0):
    """A seeded 4:2:0 Y4M stream into ``fh``: ``distinct`` different
    frames (all of them if 0), repeated to ``frames``."""
    import numpy as np

    from downloader_tpu_torch.compute.video import Y4MHeader, Y4MWriter

    rng = np.random.default_rng(seed)
    hdr = Y4MHeader(width=width, height=height, colorspace="420jpeg")
    ch, cw = hdr.chroma_shape
    # smooth gradients plus noise: natural-ish content with texture
    yy, xx = np.mgrid[0:height, 0:width]
    made = []
    for i in range(distinct or frames):
        base = (xx * 255 // width + yy * 64 // height + 9 * i) % 256
        y = np.clip(base + rng.integers(-24, 25, (height, width)), 0, 255)
        made.append((y.astype(np.uint8),
                     rng.integers(64, 192, (ch, cw)).astype(np.uint8),
                     rng.integers(64, 192, (ch, cw)).astype(np.uint8)))
    writer = Y4MWriter(fh, hdr)
    for i in range(frames):
        writer.write_frame(*made[i % len(made)])


def _read_y4m(path: Path):
    from downloader_tpu_torch.compute.video import Y4MReader

    with open(path, "rb") as fh:
        reader = Y4MReader(fh)
        return reader.header, [tuple(p.copy() for p in f) for f in reader]


def _compare_steps(a, b):
    import numpy as np

    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(diff.max()), float((diff == 0).mean())


def phase_main_path(torch, counters, work: Path, results):
    import numpy as np

    from downloader_tpu_torch import cli
    from downloader_tpu_torch.compute.ops.pixel_shuffle import quantize_u8
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler

    src, dst = work / "src.y4m", work / "dst.y4m"
    with open(src, "wb") as fh:
        _write_y4m(fh, FRAMES, WIDTH, HEIGHT, seed=3)

    # the user's entry point, as a user runs it
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "downloader_tpu_torch", "upscale", str(src),
         str(work / "dst_subprocess.y4m")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"upscale CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    _say(f"python -m downloader_tpu_torch upscale: {proc.stdout.strip()} "
         f"({time.monotonic() - t0:.2f} s with process start)")

    # the same CLI in-process, counted
    for fn in (*counters.values(), quantize_u8):
        fn.launches = 0
    t0 = time.monotonic()
    rc = cli.main(["upscale", str(src), str(dst)])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    if rc != 0:
        raise RuntimeError(f"upscale CLI main() returned {rc}")
    _say(f"upscale CLI main(): {FRAMES} frames in {time.monotonic() - t0:.2f} s; "
         f"kernel launches {launches}; standalone quantize_u8 "
         f"{quantize_u8.launches} (its uses on this path run inside the tail)")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"kernel {name} never launched on the main path")
        results[name]["launches"] = n

    hdr, out = _read_y4m(dst)
    if (hdr.width, hdr.height) != (2 * WIDTH, 2 * HEIGHT) or len(out) != FRAMES:
        raise AssertionError(f"output {hdr.width}x{hdr.height}, {len(out)} frames")
    if (work / "dst_subprocess.y4m").read_bytes() != dst.read_bytes():
        raise AssertionError("subprocess and in-process CLI outputs differ")
    _say(f"output: {hdr.width}x{hdr.height} C{hdr.colorspace}, {len(out)} frames "
         "(subprocess and in-process outputs identical)")

    # the kernel tail against the plain tail on the engine's packed output
    from downloader_tpu_torch.compute.ops.colorspace import (
        fused_subpixel_ycc_s2d,
        fused_subpixel_ycc_s2d_plain,
    )

    _, frames = _read_y4m(src)
    engine = FrameUpscaler()  # the CLI's engine: full width, seed 0, cuda
    planes = [np.stack([f[i] for f in frames[:8]]) for i in range(3)]
    dev_planes = [torch.from_numpy(p).cuda() for p in planes]
    packed = engine.packed_head(*dev_planes)
    kernel_out = fused_subpixel_ycc_s2d(packed, 2)
    for name, g, w in zip("y cb cr".split(), kernel_out,
                          fused_subpixel_ycc_s2d_plain(packed, 2)):
        _assert_equal(g, w, f"main-path tail {name}")
    _say(f"main path: the tail kernel on the engine's packed output "
         f"{tuple(packed.shape)} is byte-exact vs the plain tail (8 frames)")
    for i in range(3):
        step, exact = _compare_steps(kernel_out[i].cpu().numpy(),
                                     np.stack([f[i] for f in out[:8]]))
        if step > 1 or exact < 0.97:
            raise AssertionError(f"CLI output plane {i} vs engine: step {step}, "
                                 f"exact {exact}")
        _say(f"CLI output plane {i} vs the engine's kernel path: max step "
             f"{step}, exact share {exact:.6f}")

    # the card against the CPU's plain path, same seeded weights, small input
    small = [p[:2, :96, :128] if i == 0 else p[:2, :48, :64]
             for i, p in enumerate(planes)]
    gpu = engine.upscale_batch(*small, 2, 2)
    cpu = FrameUpscaler(device="cpu").upscale_batch(*small, 2, 2)
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        step, exact = _compare_steps(g, c)
        _say(f"card vs CPU plain path, plane {i} {g.shape}: max step {step}, "
             f"exact share {exact:.6f}")
        # the reference's own bound for a conv stack in another order
        # (tests/test_upscale.py): <=1 u8 step, >97% exact
        if step > 1 or exact <= 0.97:
            raise AssertionError(f"card vs CPU plane {i}: step {step}, exact {exact}")
    return engine


def _stage_split(torch, engine, dev):
    """Device ms of each stage of one batch, and of one body layer's conv
    and the elementwise passes around it, from CUDA events.  Its tensors
    die on return, so they never count toward a later peak."""
    from downloader_tpu_torch.compute.ops.colorspace import (
        fused_subpixel_ycc_s2d,
        upsample_chroma,
        ycbcr_to_unit_rgb,
    )
    from downloader_tpu_torch.compute.ops.s2d_head import s2d_head

    model, head = engine.model, engine.model.subpixel
    stages = {}

    def stage(name, fn):
        stages[name] = _time_ms(torch, fn, reps=10)
        return fn()

    with torch.inference_mode():
        rgb = stage("colorspace in", lambda: ycbcr_to_unit_rgb(
            dev[0].float(), upsample_chroma(dev[1].float(), 2, 2),
            upsample_chroma(dev[2].float(), 2, 2)))
        feats = stage("trunk (stem + 3 body convs)", lambda: model.trunk(rgb))
        packed = stage("s2d head conv", lambda: s2d_head(
            feats, head.weight.permute(2, 3, 1, 0), head.bias))
        stage("s2d tail kernel", lambda: fused_subpixel_ycc_s2d(packed, 2))
        x = feats.permute(0, 3, 1, 2)
        body = model.body_0
        w, b = body.weight.to(x.dtype), body.bias.to(x.dtype)[:, None, None]
        conv = stage("one body conv alone (cuDNN)",
                     lambda: torch.nn.functional.conv2d(x, w, None, padding=1))
        biased = stage("one bias add", lambda: conv + b)
        act = stage("one relu", lambda: torch.relu(biased))
        stage("one residual add", lambda: act + x)
        batch_ms = _time_ms(torch, lambda: engine._core(*dev), reps=10)
    return stages, batch_ms


class _Sink:
    """A writable that counts and drops what it is given: the encoder
    pipe's place, so the disk's speed stays out of the engine's frames/s."""

    def __init__(self):
        self.nbytes = 0

    def write(self, data) -> int:
        self.nbytes += len(data)
        return len(data)


def _traced_core(torch, engine, spans):
    """Wrap ``engine._core`` so each batch's compute on the card, queued
    between its h2d and its d2h copies, is bracketed by CUDA events.  No
    host work runs inside the bracket but the kernels' own launches."""
    core = engine._core

    def traced(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = core(*args)
        end.record()
        spans.append((start, end))
        return out

    return traced


def phase_throughput(torch, engine):
    from downloader_tpu_torch.compute.pipeline import upscaler_flops_per_frame

    for height, width in ((720, 1280), (1080, 1920)):
        batch = engine.batch_for(height, width)
        key = f"{height}p"

        def stream(frames):
            buf = io.BytesIO()
            _write_y4m(buf, frames, width, height, seed=5, distinct=batch)
            return buf.getvalue()

        data = stream(STREAM_BATCHES * batch)
        frames = STREAM_BATCHES * batch
        # warm-up: enough batches to fill the 3-deep transfer queue
        engine.upscale_to(io.BytesIO(stream(4 * batch)), _Sink())
        hops, spans, walls = {}, [], []

        def note(hop, nbytes, seconds):
            hops[hop] = hops.get(hop, 0.0) + seconds

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine._core = _traced_core(torch, engine, spans)
        try:
            with engine.hop_sink.bound(note):
                for _ in range(RUNS):
                    sink = _Sink()
                    t0 = time.monotonic()
                    done = engine.upscale_to(io.BytesIO(data), sink)
                    walls.append(time.monotonic() - t0)
                    out_bytes = frames * 6 * width * height  # 4x the pixels
                    if done != frames or sink.nbytes < out_bytes:
                        raise AssertionError(f"{key} stream: {done} of {frames} "
                                             f"frames, {sink.nbytes} bytes out")
        finally:
            del engine._core
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        busy_s = sum(s.elapsed_time(e) for s, e in spans) / 1e3
        fps = [frames / w for w in walls]
        stages, batch_ms = _stage_split(torch, engine, [
            torch.from_numpy(p).cuda() for p in _stack_planes(data, batch)])
        tflop = upscaler_flops_per_frame(engine.config, height, width) * batch / 1e12
        _say(f"{key} batch {batch}: {RUNS * frames / sum(walls):.2f} frames/s "
             f"end to end (upscale_to, {RUNS} runs of {frames} frames after a "
             f"{4 * batch}-frame warm-up; runs {', '.join(f'{f:.2f}' for f in fps)}; "
             f"spread {(max(fps) - min(fps)) / statistics.median(fps):.2%}); "
             f"wall {1e3 * sum(walls) / (RUNS * STREAM_BATCHES):.3f} ms/batch; "
             f"card computing {busy_s / sum(walls):.2%} of the wall (compute "
             f"spans {1e3 * busy_s / len(spans):.3f} ms/batch); "
             f"compute alone {batch_ms:.3f} ms/batch ({tflop:.2f} TFLOP of "
             f"plain-head convs); peak memory {peak / 2**30:.2f} GiB")
        _say(f"{key} stages (ms/batch): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items()))
        _say(f"{key} host waits over {RUNS} runs (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in hops.items()))


def _stack_planes(data: bytes, batch: int):
    """The first ``batch`` frames of a Y4M stream as stacked planes."""
    import numpy as np

    from downloader_tpu_torch.compute.video import Y4MReader

    frames = [f for f, _ in zip(Y4MReader(io.BytesIO(data)), range(batch))]
    return [np.stack([f[i] for f in frames]) for i in range(3)]


def main() -> int:
    if not (REPO / "downloader_tpu_torch" / "compute" / "csrc").is_dir():
        print("chip_smoke: the downloader_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t_start = time.monotonic()

    # 1. device and build
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card_line = smi.splitlines()[0]
    rates = _card_rates(name)
    _say(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
         f"{torch.cuda.device_count()} visible")
    _say(f"card: {card_line}")
    from downloader_tpu_torch.compute import kernels

    t0 = time.monotonic()
    libs = kernels.build()
    _say(f"kernels built in {time.monotonic() - t0:.2f} s: "
         + ", ".join(sorted(libs)))
    for lib in sorted(libs):
        kernels.function(lib)

    from downloader_tpu_torch.compute.ops.colorspace import fused_subpixel_ycc_s2d

    # the kernels of the main path, with their launch counters
    counters = {"fused_subpixel_ycc_s2d": fused_subpixel_ycc_s2d}
    results: dict = {}
    phase_quantize(torch, rates)                                # 2
    phase_tail(torch, rates, results)                           # 3
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO))
    try:
        engine = phase_main_path(torch, counters, work, results)  # 4
        phase_throughput(torch, engine)                         # 5
    finally:
        shutil.rmtree(work, ignore_errors=True)

    sources = {"fused_subpixel_ycc_s2d": "downloader_tpu_torch/compute/csrc/s2d_tail.cu"}
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": sources[k],
         "replaces": "downloader_tpu/compute/ops/pixel_shuffle.py:75",
         "launches": results[k]["launches"],
         "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"], "bound_ms": results[k]["bound_ms"],
         "bound_by": results[k]["bound_by"], "library_ms": None}
        for k in counters]}
    _say(f"total {time.monotonic() - t_start:.1f} s")
    _say(card_line)
    _say(json.dumps(line))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
