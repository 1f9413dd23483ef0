#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``downloader_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) on any error:

1. device: the card's name and power limit; build every CUDA kernel of
   ``downloader_tpu_torch/compute/csrc`` with ``nvcc`` (timed);
2. ``quantize_u8`` (standalone): kernel vs its plain PyTorch version on
   the card, byte-exact, over f32/bf16, out-of-range values, exact .5
   ties, a ragged and a misaligned input, the odd-dims branch's chroma
   plane and the generic tail's (8, 2160, 3840) f32 plane; then
   ``pixel_shuffle_clip_u8`` on (8, 540, 960, 12) maps, byte-exact with
   one launch each; timed on the generic tail's plane;
3. ``fused_subpixel_ycc_s2d``: kernel vs plain on the card, byte-exact,
   at scales 1-5 (wide-exponent and ragged inputs) and on a seeded (8,
   540, 960, 48) bf16 packed head output at scale 2; timed there; then
   the shipped build against the same source with every scale on its
   run-time loop, byte-equal and timed in turns at scales 1-4 on the
   1080p batch's packed size;
4. ``s2d_head_kernel``: kernel vs its plain version (float64 sum, one
   rounding) at the spike's (2, 64, 256, 128), a ragged shape and the
   (8, 720, 1280, 128) / (8, 1080, 1920, 128) feature maps of 720p and
   1080p batches, held to <= 1 bf16 ulp and >= 99% exact (the tensor
   cores sum f32 in another order); kernel, plain and the cuDNN conv +
   bias pass timed at 720p and 1080p;
4b. ``conv_epilogue``: each of its three variants (bias, bias + relu,
   bias + relu + residual) against its plain version (the three PyTorch
   ops) on the card, bit for bit with +-0 and NaN among the values and
   in place over the conv output, at the (8, 1080, 1920, 128) and (8,
   540, 960, 128) body maps of 1080p and 540p batches, the (8, 540, 960,
   48) x4 head map and a ragged (3, 37, 53, 12) map (the scalar
   variant); kernel and plain timed at the three full-size maps beside
   the least time for their bytes;
5. main path: a seeded 16-frame 1920x1080 4:2:0 Y4M through the port's
   ``upscale`` CLI at the model's full width (``python -m
   downloader_tpu_torch upscale`` in a subprocess, then the CLI's
   ``main()`` in-process); the output must be a 3840x2160 stream of 16
   frames, the tail kernel must match the plain tail byte for byte on
   the engine's own packed output, and the card must agree with the
   CPU's plain path on a small input;
6. the spike's path: ``python -m downloader_tpu_torch.scripts.head_spike
   check`` and ``race`` in subprocesses (exit 0), then ``check``
   in-process;
7. 4K tiled: a seeded 4-frame 3840x2160 4:2:0 Y4M through the CLI's
   ``main()``; the engine must tile it (4, 4) and write a 7680x4320
   stream; tiled vs untiled on the card with the size gate lowered,
   within 3 u8 steps and >= 99% exact (cuDNN picks its algorithm per
   batch shape);
8. generic tail: an 8-frame 1920x1080 4:4:4 Y4M through the CLI's
   ``main()``; card vs the CPU's plain path on a small input (<= 3 u8
   steps, > 90% exact, here and in phases 9-10: the reference's bound on
   its chip);
9. odd dims: an 8-frame 1919x1079 4:4:4 Y4M through a scale-1 engine's
   ``upscale_y4m`` (the configuration that reaches the odd branch);
   card vs CPU on a small input; then even dims at scale 1: an 8-frame
   1920x1080 4:4:4 Y4M through the same engine's ``upscale_y4m``, on the
   s2d branch (one scale-1 tail launch, no standalone quantize); card vs
   CPU on a small input;
10. ``infer``: ``upscale_frames`` on 4 seeded 1920x1080 RGB frames; card
   vs CPU on a small input;
11. throughput at 720p, 1080p and 4K: ``FrameUpscaler.upscale_to`` (the
   CLI's streaming path) over a 32-batch Y4M stream in memory into a
   sink that drops the bytes, after a warm-up stream that fills the
   transfer queue; frames/s over 3 runs with their spread, the share of
   the wall the card spends computing (CUDA events around each batch's
   compute), a per-stage device split (untiled cells), peak memory and
   the host's h2d/compute/d2h waits;
12. training at full width: a seeded 32-frame 1280x720 4:2:0 Y4M with
   edges and gradients; ``python -m downloader_tpu_torch train`` for 40
   steps (the last logged loss below the first), then resumed for 10
   (``resumed from step 40``, ending at step 50, at most 3 steps kept);
   two steps on the card against two on the CPU's plain path from one
   seeded init and batch (losses within ``TRAIN_LOSS_RTOL``); the card's
   checkpoint restored on the CPU bit for bit, and the CPU's resumed on
   the card; device ms/step (CUDA events) at batch 8 crop 64 and batch
   16 crop 256, fused against foreach Adam, with peak memory; steps/s
   through ``train()`` on the clip and the card's computing share (CUDA
   events, then a profiled run); all of it with every kernel's count at
   0; then ``upscale --checkpoint-dir`` on phase 5's 1080p stream (2
   tail launches, an output other than the seeded init's) and the card
   against the CPU engine from the same checkpoint (<= 3 u8 steps, > 90%
   exact);
13. the staging service at full width: the port's ``build_service``
   in-process (an in-memory broker, a filesystem store, a local HTTP
   origin serving a seeded 16-frame 1920x1080 4:2:0 Y4M) takes two
   ``Download`` jobs at once on one engine (``instance.max_concurrent_jobs``
   2); both must be staged with their done markers and 2 ``Convert``
   messages, each stream byte-identical to the engine's own
   ``upscale_to`` of the clip, each job's hop ledger must hold ``h2d``,
   ``compute`` and ``d2h``, ``frames_upscaled_total`` must read 32 and
   the tail kernel must launch twice a job; the wall per job and the
   frames/s through the stage are printed beside the card line; then
   ``python -m downloader_tpu_torch`` with no arguments (the service, the
   stage on the card) must answer ``/health`` (500 ``Not Running Jobs``
   when idle) and ``/metrics``, and stop with "shutdown complete" and
   exit 0 on SIGTERM;
14. the operator surface at full width: the port's broker copy
   (``tests/test_torch_miniamqp.py``, real AMQP bytes over loopback), the
   port's service in-process on it (``rabbitmq: {backend: amqp}``, a
   filesystem store, the stage at ``UpscalerConfig()``, batch 8, on the
   card) with its health/control server, and a local HTTP origin serving
   a seeded 16-frame 1920x1080 4:2:0 Y4M; then, each as a subprocess
   ``python -m downloader_tpu_torch <command>`` as an operator runs it,
   every exit code checked: ``submit --wait`` (exits 0 on the job's
   Convert), ``status``, ``jobs show`` (DONE, ``upscale`` among the stage
   seconds, the h2d/compute/d2h hops), ``jobs events`` (the upscale
   frames event), ``trace show`` (the ``stage.upscale`` span) and
   ``incident list`` (empty); the staged stream byte-identical to the
   engine's ``upscale_to`` of the clip, its done marker, one ``Convert``,
   ``frames_upscaled_total`` 16 and 2 tail launches on the ``operator``
   path; the wall of ``submit --wait``, the CLI's start-up (``status
   --help``) and the job's stage seconds and hops are printed beside the
   card line.

15. the multi-device path: phase 5's 16-frame 1080p 4:2:0 clip through
   ``FrameUpscaler.upscale_to`` on an engine over every visible card and
   on one over the first card listed twice (batch 16: two shards of 8),
   each byte-identical to the one-card engine's stream, the tail
   launched shards x dispatches times, and each engine's shard count and
   count of ``_dispatch`` calls printed (the latter checked against the
   frames over ``batch_for``); frames/s of the one-card and the twice-listed
   engine on a 128-frame stream in turns, beside phase 11's; then a
   one-rank NCCL group in this process where ``compile_train_step`` on a
   1x1 plan takes 3 steps at batch 8, crop 64, against the plain step
   from the same seed (losses within ``MESH_LOSS_RTOL``), with ms/step of
   each; ``dryrun_multichip`` over the visible cards (its ok line; its
   group of one process per card is spawned through ``run_group``); and
   ``measure_overlap`` on the card's engine at 720p, its source paced at
   3 ms a frame (under a batch's compute, so there is 15% to hide), best
   of 3 against the reference's alarm (overlap >= 0.5, pipelined <= 0.85
   x serial);
16. the port's lint gate on the card's machine: ``python -m
   downloader_tpu_torch.analysis --json`` in a subprocess from the repo
   root (the port's package, its tests and this script) must exit 0 with
   no finding; the files, the suppressed count, the analyzer's seconds
   and the Python version are printed;
17. the JAX package's model on the card, from the committed orbax step
   of ``UpscalerConfig()`` (``compute/orbax_reader/testdata``, written by
   the JAX package after 3 train steps): read on the card's host with
   the port's reader (which of orbax, tensorstore, zstandard and JAX are
   installed is printed; none may be loaded), ``latest_step`` 3, every
   array's sha256 the manifest's, the read's seconds and MB/s; then
   ``python -m downloader_tpu_torch upscale --checkpoint-dir`` on the
   committed 2-frame 128x72 clip against the JAX package's committed CPU
   output (<= 3 u8 steps, > 90% exact); phase 5's 16-frame 1080p stream
   through ``upscale_to`` on the restored model (frames/s; 2 tail
   launches on the ``orbax`` path); last ``train --checkpoint-dir --steps
   3`` on phase 12's clip on the card and, on another copy, on the CPU:
   each resumes from step 3 and leaves orbax step 3 beside the port's
   step 6, and the losses of steps 4 and 6 agree within 1e-3.

18. SwinIR-M x4 real-world (the benchmark's ``swinir-m-x4-real``
   configuration and seeded weights): 2 batches of 8 seeded 960x540 4:2:0
   frames through the engine's ``upscale_batch`` to 3840x2160, timed
   with peak memory; the first and last frame of each batch against the
   plain float32 reference (``portbench/reference/swinir.py``) within
   the ``swinir-x4-540p-stream`` cell's limits; then one batch under the
   profiler, printing the attention kernel's name and its launches per
   batch.  Then, at those seeded weights the attention is near uniform
   and the bias small, so one 960x540 frame runs again on weights where
   both matter (bias tables of std 2, qkv kernels of unit gain): the
   model's output (f32 RGB, before quantizing) against the plain
   reference's, and against the reference's with the bias or the shift
   mask left out; the port's worst 32x32-tile mean gap must be under a
   third of the smaller of the other two, so a card path that lost the
   bias or misread the mask fails.  ``python3 chip_smoke.py swinir``
   runs phases 1 and 18 alone.

Every path of phases 5-10, 12, 13, 14, 15, 17 and 18 runs with every kernel's launch counter set to
0 just before it and read just after; each count must be the one the
path implies (e.g. 3 standalone quantizes per generic-tail batch, 0 head
kernels on the engine's paths, an epilogue per conv of each batch's
forward: 4 on the s2d branches, 5 on the plain head, 0 in training).

It prints the card line (``nvidia-smi --query-gpu=name,power.limit``),
then one JSON line with every kernel's numbers, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run from a
directory that does not hold the port, it exits non-zero and prints no
result.  Bounds are data-sheet figures picked by the card's name.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# data-sheet memory bandwidth (bytes/s), non-tensor f32 rate and dense
# bf16 tensor-core rate (FLOP/s), by a substring of the card's name;
# first match wins (the SXM part reports no form factor in its name)
_CARDS = [
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H200", 4.8e12, 67e12, 989e12),
    ("H100", 3.35e12, 67e12, 989e12),
]

FRAMES, WIDTH, HEIGHT = 16, 1920, 1080
# conv_epilogue launches per forward: one per trunk conv (the stem and
# the body, UpscalerConfig().depth in all, checked in main()) on the s2d
# branches, whose head adds its own bias, and one more for the plain
# sub-pixel head on the generic tail, the odd-dims branch and infer
EPILOGUES_S2D = 4
EPILOGUES_PLAIN = EPILOGUES_S2D + 1
STREAM_BATCHES, RUNS = 32, 3  # throughput: batches per timed stream, runs


def _say(msg: str) -> None:
    print(msg, flush=True)


def _card_rates(name: str):
    for tag, *rates in _CARDS:
        if tag in name:
            return tuple(rates)
    raise RuntimeError(f"no data-sheet rates for card {name!r}")


def _bound_ms(nbytes: int, ops: int, rates, tensor: bool = False) -> tuple:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate of their kind (the bf16 tensor cores
    with ``tensor``, else the f32 units), whichever is larger."""
    bandwidth, f32_rate, bf16_rate = rates
    t_bytes, t_ops = nbytes / bandwidth, ops / (bf16_rate if tensor else f32_rate)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _time_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each of
    ``reps`` back-to-back calls queued behind a sleep kernel, so host
    overhead between calls does not leave the card idle."""
    for _ in range(warmup):
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
    the shapes of the driven paths, f32 and bf16; the last is the timed
    one."""
    edge = torch.rand((3, 5, 7, 13), generator=gen, device=dev) * 340 - 40
    ties = torch.randint(-3, 258, edge.shape, generator=gen, device=dev) + 0.5
    mask = torch.rand(edge.shape, generator=gen, device=dev) < 0.3
    edge = torch.where(mask, ties, edge)
    edge.view(-1)[:6] = torch.tensor([0.5, 1.5, 2.5, 254.5, 255.5, -0.5], device=dev)
    cases = [("ragged f32", edge), ("ragged bf16", edge.bfloat16()),
             ("misaligned f32", edge.view(-1)[1:]),
             ("misaligned bf16", edge.bfloat16().view(-1)[1:])]
    for label, shape in (("odd-dims chroma", (8, HEIGHT - 1, WIDTH - 1)),
                         ("generic-tail plane", (8, 2 * HEIGHT, 2 * WIDTH))):
        x = torch.randn(shape, generator=gen, device=dev) * 80 + 128
        cases.append((f"{label} {tuple(shape)} f32", x))
    return cases


def phase_quantize(torch, rates, results):
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
    _shuffle_clip(torch, gen, dev)
    ms = _time_ms(torch, lambda: quantize_u8(x))
    plain_ms = _time_ms(torch, lambda: quantize_u8_plain(x))
    nbytes = x.numel() * (x.element_size() + 1)
    bound, by = _bound_ms(nbytes, 3 * x.numel(), rates)
    results["quantize_u8"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=by, max_abs_err=0, library_ms=None)
    _say(f"quantize_u8 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
         f"bound {bound:.4f} ms ({by}, {nbytes / 1e6:.1f} MB)")


def _shuffle_clip(torch, gen, dev):
    """``pixel_shuffle_clip_u8`` on a 1080p batch's sub-pixel maps: one
    standalone quantize launch each, byte-exact against shuffle + the
    plain quantize."""
    from downloader_tpu_torch.compute.ops.pixel_shuffle import (
        pixel_shuffle,
        pixel_shuffle_clip_u8,
        quantize_u8,
        quantize_u8_plain,
    )

    x = torch.randn((8, HEIGHT // 2, WIDTH // 2, 12), generator=gen,
                    device=dev) * 80 + 128
    for label, maps in (("f32", x), ("bf16", x.bfloat16())):
        quantize_u8.launches = 0
        got = pixel_shuffle_clip_u8(maps, 2)
        torch.cuda.synchronize()
        if quantize_u8.launches != 1:
            raise AssertionError(f"pixel_shuffle_clip_u8 launched the quantize "
                                 f"kernel {quantize_u8.launches} times, not 1")
        _assert_equal(got, quantize_u8_plain(pixel_shuffle(maps.float(), 2)),
                      f"pixel_shuffle_clip_u8 {label}")
        _say(f"pixel_shuffle_clip_u8 {label} {tuple(maps.shape)} -> "
             f"{tuple(got.shape)}: byte-exact vs plain, 1 quantize launch")
    quantize_u8.launches = 0


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
    cases = []
    for scale in (1, 2, 3, 4, 5):
        c = 12 * scale * scale
        cases += [(scale, f"scale {scale} wide-exponent (2,10,12,{c})",
                   _packed_input(torch, (2, 10, 12, c), gen, dev, True)),
                  (scale, f"scale {scale} (2,36,66,{c})",
                   _packed_input(torch, (2, 36, 66, c), gen, dev))]
    cases.append((2, f"scale 2 {shape}", _packed_input(torch, shape, gen, dev)))
    for scale, label, packed in cases:
        got = fused_subpixel_ycc_s2d(packed, scale)
        torch.cuda.synchronize()
        for plane, g, w in zip("y cb cr".split(), got,
                               fused_subpixel_ycc_s2d_plain(packed, scale)):
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
    results["s2d_tail"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                               bound_by=by, max_abs_err=err, library_ms=None)
    _say(f"fused_subpixel_ycc_s2d scale 2 {shape}: kernel {ms:.4f} ms, "
         f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}, "
         f"{nbytes / 1e6:.1f} MB)")
    del packed, got
    _tail_builds(torch, rates, gen, dev)


def _tail_builds(torch, rates, gen, dev):
    """The shipped tail build against the same source built with every
    scale on the run-time loop (``-DS2D_TAIL_FIXED_SCALES=0``), byte for
    byte and timed in turns, at the main path's frame size and scales 1-4."""
    from downloader_tpu_torch.compute import kernels
    from downloader_tpu_torch.compute.ops.colorspace import launch_s2d_tail

    builds = {"shipped": kernels.function("s2d_tail"),
              **kernels.build_variants("s2d_tail", {
                  "run-time scale": {"S2D_TAIL_FIXED_SCALES": 0}})}
    for scale in (1, 2, 3, 4):
        shape = (8, HEIGHT // 2, WIDTH // 2, 12 * scale * scale)
        packed = _packed_input(torch, shape, gen, dev)
        outs = [launch_s2d_tail(packed, scale, fn) for fn in builds.values()]
        torch.cuda.synchronize()
        for plane, a, b in zip("y cb cr".split(), *outs):
            _assert_equal(a, b, f"s2d tail builds, scale {scale} {plane}")
        best = dict.fromkeys(builds, float("inf"))
        for _ in range(3):
            for name, fn in builds.items():
                best[name] = min(best[name], _time_ms(
                    torch, lambda: launch_s2d_tail(packed, scale, fn)))
        nbytes = packed.numel() * 2 + sum(t.numel() for t in outs[0])
        bound, _ = _bound_ms(nbytes, 0, rates)
        _say(f"s2d tail builds, scale {scale} {shape}: byte-equal; "
             + ", ".join(f"{name} {ms:.4f} ms" for name, ms in best.items())
             + f"; bound {bound:.4f} ms (bytes)")
        del packed, outs
        torch.cuda.empty_cache()


def _head_ulps(torch, got, want):
    """|got - want| in bf16 ulps of |want|, with magnitudes under 1/256 of
    the output's RMS counted at that floor: there, where the 2048 terms
    of a sum cancel, the f32 sum's own rounding error is more than a bf16
    ulp of the result."""
    g, w = got.float(), want.float()
    floor = w.pow(2).mean().sqrt() / 256
    _, exp = torch.frexp(torch.maximum(w.abs(), floor))
    return (g - w).abs() / torch.ldexp(torch.ones_like(w), exp - 8)


def phase_head(torch, rates, results):
    import torch.nn.functional as F

    from downloader_tpu_torch.compute.ops.s2d_head import (
        s2d_head_kernel,
        s2d_head_kernel_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    k4 = (torch.randn((4, 4, 128, 48), generator=gen, device=dev)
          / 1152 ** 0.5).bfloat16()
    bias4 = (torch.randn((48,), generator=gen, device=dev) * 0.1).bfloat16()
    w_lib = k4.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    max_abs = 0.0
    for label, shape in (("spike check", (2, 64, 256, 128)),
                         ("ragged", (3, 18, 34, 128)),
                         ("720p", (8, 720, 1280, 128)),
                         ("1080p", (8, HEIGHT, WIDTH, 128))):
        feats = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
        got = s2d_head_kernel(feats, k4, bias4)
        torch.cuda.synchronize()
        want = s2d_head_kernel_plain(feats, k4, bias4)
        worst = float(_head_ulps(torch, got, want).max())
        exact = float((got == want).double().mean())
        max_abs = max(max_abs, float((got.float() - want.float()).abs().max()))
        _say(f"s2d_head_kernel {label} {shape} -> {tuple(got.shape)}: max "
             f"{worst:.3f} bf16 ulp vs plain, exact share {exact:.6f}")
        # the tensor cores sum f32 in their own order, the plain version
        # in float64: a sum next to a bf16 rounding boundary may tip
        if worst > 1 or exact < 0.99:
            raise AssertionError(f"s2d head kernel {label}: {worst} ulp, "
                                 f"exact {exact}")
        if label not in ("720p", "1080p"):
            continue
        x = feats.permute(0, 3, 1, 2)  # the NHWC map as channels_last NCHW
        ms = _time_ms(torch, lambda: s2d_head_kernel(feats, k4, bias4), reps=10)
        lib_ms = _time_ms(torch, lambda: F.conv2d(
            x, w_lib, None, stride=2, padding=1).permute(0, 2, 3, 1) + bias4,
            reps=10)
        plain_ms = _time_ms(torch, lambda: s2d_head_kernel_plain(feats, k4, bias4),
                            reps=3, warmup=1)
        nbytes = (feats.numel() + k4.numel() + bias4.numel() + got.numel()) * 2
        ops = 2 * got.numel() * 16 * 128  # 16 taps x 128 channels per output
        bound, by = _bound_ms(nbytes, ops, rates, tensor=True)
        _say(f"s2d_head_kernel {label} {shape}: kernel {ms:.4f} ms, cuDNN conv "
             f"+ bias pass {lib_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
             f"{bound:.4f} ms ({by}; {nbytes / 1e9:.3f} GB, {ops / 1e12:.3f} "
             f"TFLOP)")
        results["s2d_head"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=by, max_abs_err=max_abs,
                                   library_ms=lib_ms)
        del feats, got, want, x
        torch.cuda.empty_cache()


def _epilogue_operand(torch, shape, gen, dev):
    """A (B, H, W, C) bf16 map made on the card, viewed as (B, C, H, W)
    channels_last as the conv gives it: normal values with ~5% -0, ~5%
    +0 and ~2% NaN."""
    x = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    pick = torch.randint(0, 100, shape, generator=gen, device=dev, dtype=torch.uint8)
    x.masked_fill_(pick < 5, -0.0)
    x.masked_fill_((pick >= 5) & (pick < 10), 0.0)
    x.masked_fill_((pick >= 10) & (pick < 12), float("nan"))
    return x.permute(0, 3, 1, 2)


def phase_epilogue(torch, rates, results):
    from downloader_tpu_torch.compute.ops.conv_epilogue import (
        conv_epilogue,
        conv_epilogue_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    variants = {"residual": (True, True), "relu": (True, False),
                "bias": (False, False)}
    for label, shape in (("1080p body", (8, HEIGHT, WIDTH, 128)),
                         ("540p body", (8, HEIGHT // 2, WIDTH // 2, 128)),
                         ("540p x4 head", (8, HEIGHT // 2, WIDTH // 2, 48)),
                         ("ragged", (3, 37, 53, 12))):
        y = _epilogue_operand(torch, shape, gen, dev)
        res = _epilogue_operand(torch, shape, gen, dev)
        bias = _epilogue_operand(torch, (1, 1, 1, shape[-1]), gen, dev).reshape(-1)
        for name, (relu, residual) in variants.items():
            x = res if residual else None
            want = conv_epilogue_plain(y, bias, relu, x)
            out = y.clone()
            got = conv_epilogue(out, bias, relu, x)
            torch.cuda.synchronize()
            differ = int((got.view(torch.int16) != want.view(torch.int16)).sum())
            if got.data_ptr() != out.data_ptr() or differ:
                raise AssertionError(f"conv_epilogue {name} {label} {shape}: "
                                     f"{differ} of {want.numel()} values differ "
                                     "from plain, or not written in place")
            del want
            if label == "ragged":
                _say(f"conv_epilogue {name} {label} {shape}: bit-exact vs plain, "
                     "in place")
                continue
            ms = _time_ms(torch, lambda: conv_epilogue(out, bias, relu, x))
            plain_ms = _time_ms(torch, lambda: conv_epilogue_plain(y, bias, relu, x))
            # the conv output (and the residual) read, the result written;
            # an add per element, a max and another add where they apply
            moved = 3 if residual else 2
            nbytes = (moved * y.numel() + bias.numel()) * 2
            bound, by = _bound_ms(nbytes, (1 + relu + residual) * y.numel(), rates)
            _say(f"conv_epilogue {name} {label} {shape}: bit-exact vs plain, in "
                 f"place; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                 f"{bound:.4f} ms ({by}, {nbytes / 1e9:.3f} GB; kernel at "
                 f"{100 * bound / ms:.1f}% of it)")
            if (name, label) == ("residual", "1080p body"):
                results["conv_epilogue"] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                    max_abs_err=0, library_ms=None)
            del out, got
        del y, res, x
        torch.cuda.empty_cache()


def _write_y4m(fh, frames: int, width: int, height: int, seed: int,
               distinct: int = 0, colorspace: str = "420jpeg"):
    """A seeded Y4M stream into ``fh``: ``distinct`` different frames
    (all of them if 0), repeated to ``frames``."""
    import numpy as np

    from downloader_tpu_torch.compute.video import Y4MHeader, Y4MWriter

    rng = np.random.default_rng(seed)
    hdr = Y4MHeader(width=width, height=height, colorspace=colorspace)
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


def _write_training_clip(fh, frames: int, width: int, height: int,
                         seed: int) -> None:
    """A seeded 4:2:0 Y4M with structure a model can learn: a smooth
    luma gradient, discs and bars with hard edges that drift from frame
    to frame, light noise, and smooth chroma gradients."""
    import numpy as np

    from downloader_tpu_torch.compute.video import Y4MHeader, Y4MWriter

    rng = np.random.default_rng(seed)
    hdr = Y4MHeader(width=width, height=height, colorspace="420jpeg")
    ch, cw = hdr.chroma_shape
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    cy, cx = np.mgrid[0:ch, 0:cw].astype(np.float32)
    discs = [(rng.uniform(0, height), rng.uniform(0, width),
              rng.uniform(20, 120), rng.uniform(-60, 60),
              rng.uniform(-6, 6), rng.uniform(-6, 6)) for _ in range(12)]
    writer = Y4MWriter(fh, hdr)
    for i in range(frames):
        y = 40 + 150 * xx / width + 40 * yy / height
        for y0, x0, r, level, vy, vx in discs:
            inside = (yy - y0 - vy * i) ** 2 + (xx - x0 - vx * i) ** 2 < r * r
            y = np.where(inside, y + level, y)
        y = np.where(((xx + 3 * i) // 48) % 2 == (yy // 96) % 2, y + 12, y)
        y = y + rng.normal(0, 3, y.shape)
        cb = 128 + 50 * np.sin(cx / cw * 6.0 + 0.1 * i) * np.cos(cy / ch * 3.0)
        cr = 128 + 50 * np.cos(cx / cw * 4.0 - 0.1 * i) * np.sin(cy / ch * 5.0)
        writer.write_frame(*(np.clip(np.rint(p), 0, 255).astype(np.uint8)
                             for p in (y, cb, cr)))


def _read_y4m(path: Path):
    from downloader_tpu_torch.compute.video import Y4MReader

    with open(path, "rb") as fh:
        reader = Y4MReader(fh)
        return reader.header, [tuple(p.copy() for p in f) for f in reader]


def _compare_steps(a, b):
    import numpy as np

    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return int(diff.max()), float((diff == 0).mean())


def _card_vs_cpu(label: str, gpu, cpu, chip_bound: bool = False) -> None:
    """The card against the CPU's plain path on the same weights, held to
    the reference's own bound for its conv stack summed in another order:
    on the CPU <= 1 u8 step and > 97% exact (tests/test_upscale.py); on
    its chip <= 3 steps at ~72% exact (BASELINE.md:402), held here at
    > 90%.  ``chip_bound`` takes the second where cuDNN's bf16 sums move
    a feature by an ulp that the layers after it carry to a few steps."""
    import numpy as np

    max_step, min_exact = (3, 0.90) if chip_bound else (1, 0.97)
    for i, (g, c) in enumerate(zip(gpu, cpu)):
        step, exact = _compare_steps(g, c)
        over = int((np.abs(g.astype(np.int16) - c.astype(np.int16)) > 1).sum())
        _say(f"{label}: card vs CPU plain path, plane {i} {g.shape}: max step "
             f"{step}, exact share {exact:.6f}, {over} values > 1 step")
        if step > max_step or exact <= min_exact:
            raise AssertionError(f"{label} card vs CPU plane {i}: step {step}, "
                                 f"exact {exact}")


class _Launches:
    """Every kernel wrapper's launch count per driven path: the counts are
    set to 0 just before the path runs and read just after, and must be
    exactly the ones the path implies."""

    def __init__(self, torch, wrappers):
        self.torch, self.wrappers, self.by_path = torch, wrappers, {}

    @contextlib.contextmanager
    def path(self, name: str, expect: dict):
        for fn in self.wrappers.values():
            fn.launches = 0
        yield
        self.torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in self.wrappers.items()}
        self.by_path[name] = got
        _say(f"{name} path: kernel launches {got}")
        want = {k: expect.get(k, 0) for k in self.wrappers}
        if got != want:
            raise AssertionError(f"{name} path launched {got}, expected {want}")


def _s2d_cores(n: int) -> dict:
    """The launches of ``n`` forwards on an s2d branch: a tail each and
    an epilogue per trunk conv."""
    return {"s2d_tail": n, "conv_epilogue": EPILOGUES_S2D * n}


def _plain_head_cores(n: int) -> dict:
    """The launches of ``n`` forwards on the plain head (the generic tail
    and the odd-dims branch): three standalone quantizes and an epilogue
    per conv each."""
    return {"quantize_u8": 3 * n, "conv_epilogue": EPILOGUES_PLAIN * n}


def _run_cli(cli, *args) -> float:
    t0 = time.monotonic()
    rc = cli.main(["upscale", *map(str, args)])
    if rc != 0:
        raise RuntimeError(f"upscale CLI main() returned {rc}")
    return time.monotonic() - t0


def phase_main_path(torch, launches, work: Path):
    import numpy as np

    from downloader_tpu_torch import cli
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

    # the same CLI in-process, counted: one tail launch per batch of 8,
    # its three quantizes inline (the standalone kernel stays at 0)
    with launches.path("main", _s2d_cores(FRAMES // 8)):
        wall = _run_cli(cli, src, dst)
    _say(f"upscale CLI main(): {FRAMES} frames in {wall:.2f} s")

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
    _card_vs_cpu("main path", engine.upscale_batch(*small, 2, 2),
                 FrameUpscaler(device="cpu").upscale_batch(*small, 2, 2))
    return engine


def phase_spike(torch, launches):
    """The spike's path: its entry as a user runs it, then in-process,
    counted (one head launch per ``check``)."""
    from downloader_tpu_torch.scripts import head_spike

    for mode in ("check", "race"):
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "downloader_tpu_torch.scripts.head_spike", mode],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"head_spike {mode} exited {proc.returncode}: "
                               f"{proc.stderr[-2000:]}")
        for line in proc.stdout.strip().splitlines():
            _say(f"head_spike {mode}: {line}")
        _say(f"head_spike {mode}: exit 0 ({time.monotonic() - t0:.2f} s with "
             "process start)")
    out = io.StringIO()
    with launches.path("spike", {"s2d_head": 1}):
        with contextlib.redirect_stdout(out):
            rc = head_spike.main(["check"])
    lines = out.getvalue().splitlines()
    if rc != 0 or len(lines) != 4 or not lines[1].startswith("shapes:"):
        raise AssertionError(f"head_spike check in-process: rc {rc}, {lines}")
    _say("head_spike check in-process: " + "; ".join(lines[1:]))


def phase_4k(torch, launches, work: Path):
    """A 4K 4:2:0 stream through the CLI: batch_for gives 2 frames, so the
    engine tiles each dispatch (4, 4) into 32 tiles of 556x976, all on the
    s2d branch: one tail launch per dispatch."""
    import numpy as np

    from downloader_tpu_torch import cli
    from downloader_tpu_torch.compute import pipeline

    width, height, frames = 3840, 2160, 4
    src, dst = work / "src4k.y4m", work / "dst4k.y4m"
    with open(src, "wb") as fh:
        _write_y4m(fh, frames, width, height, seed=6)
    grids = []
    decide = pipeline._tile_grid

    def recorded(*args, **kwargs):
        grids.append(decide(*args, **kwargs))
        return grids[-1]

    pipeline._tile_grid = recorded
    try:
        with launches.path("4k_tiled", _s2d_cores(frames // 2)):
            wall = _run_cli(cli, src, dst)
    finally:
        pipeline._tile_grid = decide
    if not grids or set(grids) != {(4, 4)}:
        raise AssertionError(f"4K dispatches took tile grids {grids}, not (4, 4)")
    hdr, out = _read_y4m(dst)
    if (hdr.width, hdr.height) != (2 * width, 2 * height) or len(out) != frames:
        raise AssertionError(f"4K output {hdr.width}x{hdr.height}, {len(out)} frames")
    _say(f"4K CLI main(): {frames} frames in {wall:.2f} s, tile grid (4, 4) on "
         f"{len(grids)} dispatches, output {hdr.width}x{hdr.height} "
         f"C{hdr.colorspace}")
    del out

    # tiled against untiled on the card, the size gate lowered.  Byte-exact
    # on the CPU (tests/test_torch_paths.py); on the card cuDNN picks its
    # conv algorithm per batch shape (32 tiles of 40x48 against 2 frames
    # of 96x128), its bf16 sums round in another order, and four conv
    # layers carry a feature's ulp to a few u8 steps on a few values
    # (measured: max 3 steps, 99.60% exact).  Held to <= 3 steps (the
    # reference's own bound for its conv stack summed in another order on
    # its chip, BASELINE.md:402) and >= 99% exact.
    rng = np.random.default_rng(7)
    y = rng.integers(0, 256, (2, 96, 128), np.uint8)
    cb, cr = (rng.integers(0, 256, (2, 48, 64), np.uint8) for _ in range(2))
    engine = pipeline.FrameUpscaler(batch=2)
    untiled = engine.upscale_batch(y, cb, cr, 2, 2)
    gate = pipeline.TILE_MIN_PX
    pipeline.TILE_MIN_PX = 1000
    try:
        grid = engine.tile_grid(96, 128, 2, 2)
        tiled = engine.upscale_batch(y, cb, cr, 2, 2)
    finally:
        pipeline.TILE_MIN_PX = gate
    if grid == (1, 1):
        raise AssertionError("the lowered gate did not tile the small input")
    for i, (t, u) in enumerate(zip(tiled, untiled)):
        step, exact = _compare_steps(t, u)
        over = int((np.abs(t.astype(np.int16) - u.astype(np.int16)) > 1).sum())
        _say(f"tiled {grid} vs untiled on the card, plane {i} {t.shape}: max "
             f"step {step}, exact share {exact:.6f}, {over} values > 1 step")
        if step > 3 or exact < 0.99:
            raise AssertionError(f"tiled vs untiled plane {i}: step {step}, "
                                 f"exact {exact}")


def phase_generic(torch, launches, work: Path):
    """1080p 4:4:4 at scale 2 (chroma subsampling != scale) through the
    CLI: the generic tail, three standalone quantizes per batch."""
    import numpy as np

    from downloader_tpu_torch import cli
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler

    frames = 8
    src, dst = work / "src444.y4m", work / "dst444.y4m"
    with open(src, "wb") as fh:
        _write_y4m(fh, frames, WIDTH, HEIGHT, seed=9, colorspace="444")
    with launches.path("generic_tail", _plain_head_cores(frames // 8)):
        wall = _run_cli(cli, src, dst)
    hdr, out = _read_y4m(dst)
    if ((hdr.width, hdr.height, hdr.colorspace) != (2 * WIDTH, 2 * HEIGHT, "444")
            or len(out) != frames or out[0][1].shape != (2 * HEIGHT, 2 * WIDTH)):
        raise AssertionError(f"4:4:4 output {hdr.width}x{hdr.height} "
                             f"C{hdr.colorspace}, {len(out)} frames")
    _say(f"4:4:4 CLI main(): {frames} frames in {wall:.2f} s, output "
         f"{hdr.width}x{hdr.height} C{hdr.colorspace}")
    rng = np.random.default_rng(10)
    small = [rng.integers(0, 256, (2, 48, 64), np.uint8) for _ in range(3)]
    _card_vs_cpu("generic tail", FrameUpscaler().upscale_batch(*small, 1, 1),
                 FrameUpscaler(device="cpu").upscale_batch(*small, 1, 1),
                 chip_bound=True)


def phase_odd(torch, launches, work: Path):
    """Odd frame dims reach the plain-head branch only where chroma
    subsampling equals the scale and a Y4M can carry them: scale 1 on
    4:4:4.  Three standalone quantizes per batch."""
    import numpy as np

    from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler

    config = UpscalerConfig(scale=1)
    width, height, frames = WIDTH - 1, HEIGHT - 1, 8
    src, dst = work / "src_odd.y4m", work / "dst_odd.y4m"
    with open(src, "wb") as fh:
        _write_y4m(fh, frames, width, height, seed=11, colorspace="444")
    engine = FrameUpscaler(config)
    t0 = time.monotonic()
    with launches.path("odd_dims", _plain_head_cores(frames // 8)):
        done = engine.upscale_y4m(str(src), str(dst))
    hdr, out = _read_y4m(dst)
    if done != frames or (hdr.width, hdr.height) != (width, height) or len(out) != frames:
        raise AssertionError(f"odd output {hdr.width}x{hdr.height}, {len(out)} frames")
    _say(f"scale-1 4:4:4 {width}x{height} upscale_y4m: {frames} frames in "
         f"{time.monotonic() - t0:.2f} s")
    rng = np.random.default_rng(12)
    small = [rng.integers(0, 256, (2, 47, 63), np.uint8) for _ in range(3)]
    _card_vs_cpu("odd dims", engine.upscale_batch(*small, 1, 1),
                 FrameUpscaler(config, device="cpu").upscale_batch(*small, 1, 1),
                 chip_bound=True)


def phase_scale1_s2d(torch, launches, work: Path):
    """Even dims at scale 1 on 4:4:4 (chroma subsampling == scale) take
    the s2d branch: the s2d head, then the tail kernel at scale 1, one
    launch per batch and no standalone quantize."""
    import numpy as np

    from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler

    config = UpscalerConfig(scale=1)
    frames = 8
    src, dst = work / "src_s1.y4m", work / "dst_s1.y4m"
    with open(src, "wb") as fh:
        _write_y4m(fh, frames, WIDTH, HEIGHT, seed=14, colorspace="444")
    engine = FrameUpscaler(config)
    t0 = time.monotonic()
    with launches.path("scale1_s2d", _s2d_cores(frames // 8)):
        done = engine.upscale_y4m(str(src), str(dst))
    hdr, out = _read_y4m(dst)
    if (done != frames or (hdr.width, hdr.height, hdr.colorspace) != (WIDTH, HEIGHT, "444")
            or len(out) != frames or out[0][1].shape != (HEIGHT, WIDTH)):
        raise AssertionError(f"scale-1 output {hdr.width}x{hdr.height} "
                             f"C{hdr.colorspace}, {len(out)} frames")
    _say(f"scale-1 4:4:4 {WIDTH}x{HEIGHT} upscale_y4m (s2d branch): {frames} "
         f"frames in {time.monotonic() - t0:.2f} s")
    rng = np.random.default_rng(15)
    small = [rng.integers(0, 256, (2, 48, 64), np.uint8) for _ in range(3)]
    _card_vs_cpu("scale-1 s2d", engine.upscale_batch(*small, 1, 1),
                 FrameUpscaler(config, device="cpu").upscale_batch(*small, 1, 1),
                 chip_bound=True)


def phase_infer(torch, launches):
    """The RGB ``infer`` path on 1080p frames: the full forward, then one
    standalone quantize of the whole (B, 2H, 2W, 3) output."""
    import numpy as np

    from downloader_tpu_torch.compute.infer import upscale_frames
    from downloader_tpu_torch.compute.models.upscaler import Upscaler

    params = Upscaler(seed=0).state_dict()
    frames = np.random.default_rng(13).integers(0, 256, (4, HEIGHT, WIDTH, 3),
                                                np.uint8)
    t0 = time.monotonic()
    # synchronizes on exit
    with launches.path("infer", {"quantize_u8": 1, "conv_epilogue": EPILOGUES_PLAIN}):
        out = upscale_frames(params, frames)
    if (tuple(out.shape) != (4, 2 * HEIGHT, 2 * WIDTH, 3)
            or out.dtype != torch.uint8 or out.device.type != "cuda"):
        raise AssertionError(f"infer output {tuple(out.shape)} {out.dtype} "
                             f"on {out.device}")
    _say(f"upscale_frames: {tuple(frames.shape)} -> {tuple(out.shape)} u8 in "
         f"{time.monotonic() - t0:.2f} s")
    small = frames[:2, :32, :48]
    _card_vs_cpu("infer", [upscale_frames(params, small).cpu().numpy()],
                 [upscale_frames(params, small, device="cpu").numpy()],
                 chip_bound=True)


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
    return stages


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


def phase_throughput(torch, engine) -> dict:
    """Frames/s end to end per resolution (returned), with the card's
    computing share, the stage split and the host's waits."""
    from downloader_tpu_torch.compute.pipeline import upscaler_flops_per_frame

    rates = {}

    for height, width in ((720, 1280), (1080, 1920), (2160, 3840)):
        batch = engine.batch_for(height, width)
        grid = engine.tile_grid(height, width, 2, 2)
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
        dev = [torch.from_numpy(p).cuda() for p in _stack_planes(data, batch)]
        with torch.inference_mode():
            batch_ms = _time_ms(torch, lambda: engine._core(*dev, 2, 2), reps=10)
        # the per-stage split follows one untiled batch
        stages = _stage_split(torch, engine, dev) if grid == (1, 1) else {}
        del dev
        tflop = upscaler_flops_per_frame(engine.config, height, width) * batch / 1e12
        _say(f"{key} batch {batch}, tile grid {grid}: "
             f"{RUNS * frames / sum(walls):.2f} frames/s "
             f"end to end (upscale_to, {RUNS} runs of {frames} frames after a "
             f"{4 * batch}-frame warm-up; runs {', '.join(f'{f:.2f}' for f in fps)}; "
             f"spread {(max(fps) - min(fps)) / statistics.median(fps):.2%}); "
             f"wall {1e3 * sum(walls) / (RUNS * STREAM_BATCHES):.3f} ms/batch; "
             f"card computing {busy_s / sum(walls):.2%} of the wall (compute "
             f"spans {1e3 * busy_s / len(spans):.3f} ms/batch); "
             f"compute alone {batch_ms:.3f} ms/batch ({tflop:.2f} TFLOP of "
             f"plain-head convs on the untiled frames); peak memory "
             f"{peak / 2**30:.2f} GiB")
        rates[key] = RUNS * frames / sum(walls)
        if stages:
            _say(f"{key} stages (ms/batch): " + ", ".join(
                f"{k} {v:.3f}" for k, v in stages.items()))
        _say(f"{key} host waits over {RUNS} runs (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in hops.items()))
    return rates


TRAIN_FRAMES, TRAIN_WIDTH, TRAIN_HEIGHT = 32, 1280, 720
# card against the CPU's plain path, one train step each from the same
# init and batch: bf16 forwards whose sums cuDNN and the CPU order
# differently.  The first loss is the forward alone; the second follows
# one Adam step, whose update is +-lr wherever a gradient's sign holds
TRAIN_LOSS_RTOL = (1e-3, 1e-2)


def _train_cli(args, what: str) -> list:
    """``python -m downloader_tpu_torch train ARGS`` as a user runs it;
    its output lines.  Any exit but 0 fails the run."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "downloader_tpu_torch", "train", *map(str, args)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"train CLI ({what}) exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        _say(f"train CLI ({what}): {line}")
    _say(f"train CLI ({what}): exit 0 ({time.monotonic() - t0:.2f} s with "
         "process start)")
    return lines


def _logged_losses(lines) -> dict:
    return {int(line.split()[1]): float(line.split()[3])
            for line in lines if line.startswith("step ")}


def _train_batch(torch, paths, batch: int, crop: int, seed: int):
    """One (lr, hr) batch cut as the trainer cuts it, as CPU tensors."""
    import numpy as np

    from downloader_tpu_torch.compute.trainer import box_downsample, hr_crop_stream

    crops = hr_crop_stream(paths, crop, np.random.default_rng(seed))
    hr = np.stack([next(crops) for _ in range(batch)])
    return (torch.from_numpy(box_downsample(hr, 2).astype(np.float32)),
            torch.from_numpy(hr))


def _train_card_vs_cpu(torch, paths, work: Path):
    """Two steps on the card and two on the CPU's plain path from the same
    seeded init and batch; then a checkpoint saved on the card restores on
    the CPU as the same state, and one saved on the CPU resumes on the
    card."""
    from downloader_tpu_torch.compute import checkpoint
    from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
    from downloader_tpu_torch.compute.train import make_train_step

    config = UpscalerConfig()
    card_step, card_init = make_train_step(config)
    cpu_step, cpu_init = make_train_step(config, device="cpu")
    lr, hr = _train_batch(torch, paths, 8, 64, seed=31)
    card, cpu = card_init(5), cpu_init(5)
    for name, value in card.model.state_dict().items():
        if not torch.equal(value.cpu(), cpu.model.state_dict()[name]):
            raise AssertionError(f"seeded init differs on the card: {name}")
    lr_d, hr_d = lr.cuda(), hr.cuda()
    got = [float(card_step(card, lr_d, hr_d)) for _ in range(2)]
    want = [float(cpu_step(cpu, lr, hr)) for _ in range(2)]
    rel = [abs(g - w) / w for g, w in zip(got, want)]
    _say(f"train step, full width, batch 8 crop 64: card losses "
         f"{got[0]:.7f}, {got[1]:.7f}; CPU {want[0]:.7f}, {want[1]:.7f}; "
         f"relative differences {rel[0]:.3e}, {rel[1]:.3e} (bounds "
         f"{TRAIN_LOSS_RTOL[0]:g}, {TRAIN_LOSS_RTOL[1]:g})")
    if any(r > bound for r, bound in zip(rel, TRAIN_LOSS_RTOL)):
        raise AssertionError(f"train step card vs CPU: relative {rel}")

    card_dir, cpu_dir = work / "ckpt_card", work / "ckpt_cpu"
    checkpoint.save_state(card_dir, 2, card.model.state_dict(),
                          card.optimizer.state_dict())
    restored = cpu_init(9)
    step, params, opt_state = checkpoint.restore_state(
        card_dir, restored.model.state_dict())
    restored.model.load_state_dict(params)
    checkpoint.load_optimizer_state(restored.optimizer, opt_state)
    card_opt = card.optimizer.state_dict()["state"]
    for i, entry in restored.optimizer.state_dict()["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            if not torch.equal(entry[key].float(), card_opt[i][key].cpu().float()):
                raise AssertionError(f"optimizer state {i}/{key} differs after "
                                     "the card -> CPU round trip")
    for name, value in card.model.state_dict().items():
        if not torch.equal(value.cpu(), restored.model.state_dict()[name]):
            raise AssertionError(f"param {name} differs after the card -> CPU "
                                 "round trip")
    cpu_next = float(cpu_step(restored, lr, hr))
    checkpoint.save_state(cpu_dir, 3, restored.model.state_dict(),
                          restored.optimizer.state_dict())
    resumed = card_init(11)
    _, params, opt_state = checkpoint.restore_state(cpu_dir, resumed.model.state_dict())
    resumed.model.load_state_dict(params)
    checkpoint.load_optimizer_state(resumed.optimizer, opt_state)
    card_next = float(card_step(resumed, lr_d, hr_d))
    if not (step == 2 and all(map(math.isfinite, (cpu_next, card_next)))):
        raise AssertionError(f"resumed steps: {step}, {cpu_next}, {card_next}")
    _say(f"checkpoint saved on the card restores on the CPU bit for bit "
         f"(params, Adam moments, step count {int(card_opt[0]['step'])}) and "
         f"steps on (loss {cpu_next:.7f}); saved on the CPU it resumes on the "
         f"card (loss {card_next:.7f})")


# train steps queued at once behind a sleep kernel: a step makes ~150
# launches, and CUDA blocks the host once about a thousand are pending,
# so 5 steps are all queued before the card starts on them; 10 or 20 are
# not, and the later ones would run at the host's pace
QUEUED_STEPS = 5


def _train_step_times(torch, paths):
    """Device ms per step by CUDA events, back to back on a fixed batch,
    at the trainer's default size and at a card-sized one, with the fused
    Adam (the port's) and the foreach Adam in turns; the host's own pace
    per step, synchronised and not; peak memory."""
    from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
    from downloader_tpu_torch.compute.pipeline import upscaler_flops_per_frame
    from downloader_tpu_torch.compute.train import make_train_step

    config = UpscalerConfig()
    step, init = make_train_step(config)
    for batch, crop in ((8, 64), (16, 256)):
        lr, hr = (t.cuda() for t in _train_batch(torch, paths, batch, crop, seed=41))
        state = init(0)
        fused = state.optimizer
        foreach = torch.optim.Adam(state.model.parameters(), lr=1e-3,
                                   betas=(0.9, 0.999), eps=1e-8, foreach=True)
        step(state, lr, hr)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        best = {"fused": float("inf"), "foreach": float("inf")}
        for name in ("fused", "foreach") * 3:
            state.optimizer = fused if name == "fused" else foreach
            best[name] = min(best[name], _time_ms(
                torch, lambda: step(state, lr, hr), reps=QUEUED_STEPS))
        peak = torch.cuda.max_memory_allocated()
        state.optimizer = fused
        t0 = time.monotonic()
        for _ in range(10):
            step(state, lr, hr)
            torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 100
        torch.cuda._sleep(100_000_000)  # the card stays busy meanwhile
        t0 = time.monotonic()
        for _ in range(QUEUED_STEPS):
            step(state, lr, hr)
        enqueue_ms = (time.monotonic() - t0) * 1e3 / QUEUED_STEPS
        torch.cuda.synchronize()
        if (batch, crop) == (8, 64):
            _step_runtime_calls(torch, lambda: step(state, lr, hr))
        # forward, its recompute under the checkpoint, and a backward of
        # twice the forward's matmul work
        tflop = 4 * upscaler_flops_per_frame(config, crop // 2, crop // 2) * batch / 1e12
        _say(f"train step batch {batch} crop {crop}: device {best['fused']:.3f} "
             f"ms/step with the fused Adam, {best['foreach']:.3f} with the "
             f"foreach Adam (CUDA events, median of {QUEUED_STEPS} steps queued "
             f"back to back, best of 3 turns); host {wall_ms:.3f} ms per "
             f"synchronised step, {enqueue_ms:.3f} ms per step queued without "
             f"waiting; {tflop:.4f} TFLOP of conv work a step, "
             f"{tflop / best['fused'] * 1e3:.1f} TFLOP/s; peak memory "
             f"{peak / 2**30:.3f} GiB")
        del lr, hr, state, fused, foreach
        torch.cuda.empty_cache()


def _step_runtime_calls(torch, run_step, steps: int = 3) -> None:
    """What the host calls into the CUDA runtime during a few train steps
    (``torch.profiler`` with CPU activity): launches, and any call that
    waits for the card, with the ops that read a device value."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
    waits = ("aten::item", "aten::_local_scalar_dense", "aten::nonzero",
             "aten::is_nonzero")
    calls = sorted((e for e in prof.key_averages()
                    if e.key.startswith("cu") or e.key in waits),
                   key=lambda e: -e.cpu_time_total)
    _say(f"train step batch 8 crop 64, {steps} steps profiled on the host: "
         + ", ".join(f"{e.key} x{e.count} {e.cpu_time_total / 1e3:.3f} ms"
                     for e in calls[:12]))


def _train_end_to_end(torch, paths, steps: int = 30):
    """``train()`` on the clip as the CLI runs it (batch 8, crop 64), after
    a short warm-up: steps/s over the wall, and the share of that wall in
    which the card computes (CUDA events around each step, which also
    count any gap inside a step; then a profiled run summing the kernels'
    own device time)."""
    from torch.profiler import ProfilerActivity, profile

    from downloader_tpu_torch.compute import trainer

    settings = trainer.TrainerSettings(steps=steps, log_every=10)
    trainer.train(paths, trainer.TrainerSettings(steps=3))  # warm-up
    spans = []
    make = trainer.compile_train_step

    def traced_make(*args, **kwargs):
        step, init, plan = make(*args, **kwargs)

        def traced(state, lr, hr):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            loss = step(state, lr, hr)
            end.record()
            spans.append((start, end))
            return loss

        return traced, init, plan

    lines = []
    trainer.compile_train_step = traced_make
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        summary = trainer.train(paths, settings, log=lines.append)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        trainer.compile_train_step = make
    busy = sum(s.elapsed_time(e) for s, e in spans) / 1e3
    for line in lines:
        _say(f"train() on the clip: {line}")
    _say(f"train() end to end, batch 8 crop 64, {steps} steps: "
         f"{steps / wall:.3f} steps/s ({1e3 * wall / steps:.2f} ms/step of "
         f"wall); card computing {busy / wall:.2%} of the wall by CUDA events "
         f"around each step ({1e3 * busy / steps:.3f} ms/step)")

    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train(paths, trainer.TrainerSettings(steps=10))
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    def device_us(event):
        return getattr(event, "self_device_time_total",
                       getattr(event, "self_cuda_time_total", 0))

    kernels = [e for e in prof.key_averages() if device_us(e)]
    kernel_us = sum(map(device_us, kernels))
    top = sorted(kernels, key=device_us, reverse=True)[:6]
    if kernel_us:
        _say(f"train() profiled, 10 steps: {sum(e.count for e in kernels)} "
             f"device activities of {len(kernels)} kinds, {kernel_us / 1e3:.3f} "
             f"ms of {1e3 * wall:.1f} ms wall ({kernel_us / 1e6 / wall:.2%}; "
             "the profiler's own cost is in the wall); top: " + ", ".join(
                 f"{e.key[:48]} x{e.count} {device_us(e) / 1e3:.2f} ms"
                 for e in top))
    else:
        _say("train() profiled: the profiler recorded no device time; the "
             "kernels' share is not measured")
    return summary


def phase_train(torch, launches, work: Path):
    """Training at full width: the ``train`` CLI as a user runs it (40
    steps, then resumed for 10), the card against the CPU, checkpoints
    across devices, step times and end-to-end steps/s under a launch
    count of 0 for every kernel, then ``upscale --checkpoint-dir``."""
    import numpy as np

    from downloader_tpu_torch import cli
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler

    t_phase = time.monotonic()
    data = work / "train_media"
    data.mkdir()
    clip = data / "clip.y4m"
    with open(clip, "wb") as fh:
        _write_training_clip(fh, TRAIN_FRAMES, TRAIN_WIDTH, TRAIN_HEIGHT, seed=21)
    ckpt = work / "ckpt"

    first = _train_cli(["--data", data, "--steps", 40, "--save-every", 20,
                        "--checkpoint-dir", ckpt], "40 steps")
    losses = _logged_losses(first)
    if (list(losses) != [1, 20, 40] or not losses[40] < losses[1]
            or first[-1].split()[:4] != ["trained", "to", "step", "40"]):
        raise AssertionError(f"train CLI: losses {losses}, last line {first[-1]!r}")
    second = _train_cli(["--data", data, "--steps", 10, "--save-every", 20,
                         "--checkpoint-dir", ckpt], "resumed, 10 steps")
    kept = sorted(int(name) for name in os.listdir(ckpt))
    if (second[0] != "resumed from step 40" or "trained to step 50" not in second[-1]
            or kept != [20, 40, 50]):
        raise AssertionError(f"train CLI resume: {second[0]!r}, {second[-1]!r}, "
                             f"steps kept {kept}")
    _say("loss trajectory (train CLI, batch 8 crop 64): " + ", ".join(
        f"step {s} {v:.6f}" for s, v in {**losses, **_logged_losses(second)}.items())
         + f"; checkpoints kept {kept}")

    paths = [str(clip)]
    with launches.path("train", {}):
        _train_card_vs_cpu(torch, paths, work)
        _train_step_times(torch, paths)
        _train_end_to_end(torch, paths)

    # the trained checkpoint through the upscale CLI: 16 frames of 1080p,
    # one tail launch per batch of 8, as on the main path
    src, seeded = work / "src.y4m", work / "dst.y4m"
    dst = work / "dst_trained.y4m"
    with launches.path("upscale_checkpoint", _s2d_cores(FRAMES // 8)):
        wall = _run_cli(cli, src, dst, "--checkpoint-dir", ckpt)
    hdr, out = _read_y4m(dst)
    if (hdr.width, hdr.height) != (2 * WIDTH, 2 * HEIGHT) or len(out) != FRAMES:
        raise AssertionError(f"trained output {hdr.width}x{hdr.height}, "
                             f"{len(out)} frames")
    if dst.read_bytes() == seeded.read_bytes():
        raise AssertionError("upscale --checkpoint-dir wrote the seeded init's output")
    _, seeded_out = _read_y4m(seeded)
    changed = float(np.mean([(a != b).mean() for a, b in zip(out[0], seeded_out[0])]))
    _say(f"upscale CLI main() --checkpoint-dir (step 50): {FRAMES} frames in "
         f"{wall:.2f} s, {hdr.width}x{hdr.height}; {changed:.2%} of the first "
         "frame's bytes differ from the seeded init's output")
    _, frames = _read_y4m(src)
    small = [np.stack([f[i] for f in frames[:2]]) for i in range(3)]
    small = [small[0][:, :96, :128], small[1][:, :48, :64], small[2][:, :48, :64]]
    _card_vs_cpu("trained checkpoint", FrameUpscaler(checkpoint_dir=str(ckpt))
                 .upscale_batch(*small, 2, 2),
                 FrameUpscaler(device="cpu", checkpoint_dir=str(ckpt))
                 .upscale_batch(*small, 2, 2), chip_bound=True)
    _say(f"train phase: {time.monotonic() - t_phase:.1f} s")


SERVICE_JOBS = 2  # jobs published at once; max_concurrent_jobs is 2


async def _drive_service(torch, launches, work: Path, clip: Path) -> dict:
    """Two jobs of ``clip`` through the port's ``build_service`` at once:
    an in-memory broker, a filesystem store, a local HTTP origin; the
    staged streams, markers, records and metrics, read back."""
    from aiohttp import web

    from downloader_tpu_torch import schemas
    from downloader_tpu_torch.app import build_service
    from downloader_tpu_torch.mq import InMemoryBroker
    from downloader_tpu_torch.platform.config import ConfigNode
    from downloader_tpu_torch.stages.upload import parse_done_marker
    from downloader_tpu_torch.store.fs import FilesystemObjectStore

    body = clip.read_bytes()

    async def serve(_request):
        return web.Response(body=body)

    app = web.Application()
    app.router.add_get("/{job}/clip.y4m", serve)
    origin = web.AppRunner(app)
    await origin.setup()
    site = web.TCPSite(origin, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
    broker = InMemoryBroker(max_redeliveries=3)
    store = FilesystemObjectStore(str(work / "service_store"))
    config = ConfigNode({"instance": {
        "download_path": str(work / "service_downloads"),
        "max_concurrent_jobs": SERVICE_JOBS,
        "upscale": {"enabled": True},  # UpscalerConfig(), batch 8, cuda
    }})
    orchestrator, metrics, _telemetry = build_service(config, broker, store)
    await orchestrator.start()
    jobs = [f"service-{i}" for i in range(SERVICE_JOBS)]
    staged_name = base64.b64encode(b"clip.2x.y4m").decode()
    try:
        # 2 tail launches a job: 16 frames at batch 8
        with launches.path("service", _s2d_cores(SERVICE_JOBS * FRAMES // 8)):
            t0 = time.monotonic()
            for job in jobs:
                broker.publish(schemas.DOWNLOAD_QUEUE, schemas.encode(
                    schemas.Download(media=schemas.Media(
                        id=job, creator_id="chip-smoke",
                        type=schemas.MediaType.Value("MOVIE"),
                        source=schemas.SourceType.Value("HTTP"),
                        source_uri=f"{base}/{job}/clip.y4m"))))
            await broker.join(schemas.DOWNLOAD_QUEUE, timeout=600)
            wall = time.monotonic() - t0
        result = {"wall": wall, "converts": len(broker.published(
            schemas.CONVERT_QUEUE)), "jobs": {}}
        for job in jobs:
            record = orchestrator.registry.get(job)
            marker = await store.get_object("triton-staging", f"{job}/original/done")
            result["jobs"][job] = {
                "state": record.state, "workload": record.workload,
                "done": parse_done_marker(marker)["done"],
                "stage_seconds": dict(record.stage_seconds),
                "hops": record.hops.summary() if record.hops is not None else {},
                "staged": await store.get_object(
                    "triton-staging", f"{job}/original/{staged_name}"),
            }
        result["frames_upscaled"] = metrics.frames_upscaled._value.get()
        result["engine"] = orchestrator.stage_resources["upscale.engine"]
    finally:
        await orchestrator.shutdown(grace_seconds=30)
        await origin.cleanup()
    return result


def _service_entry_point(work: Path) -> None:
    """``python -m downloader_tpu_torch`` with no arguments, as an operator
    starts the service: the memory broker, a filesystem store, the stage
    on; ``/health`` until it answers, ``/metrics``, then SIGTERM."""
    import signal
    import socket
    import urllib.error
    import urllib.request

    conf = work / "service_config"
    conf.mkdir()
    (conf / "converter.yaml").write_text(
        f"instance:\n  download_path: {work / 'entry_downloads'}\n"
        "  upscale: {enabled: true}\n"
        "rabbitmq: {backend: memory}\n"
        f"minio: {{backend: fs, root: {work / 'entry_store'}}}\n")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, CONFIG_PATH=str(conf), PORT=str(port))

    def get(path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=10) as resp:
                return resp.status, resp.read().decode()
        except urllib.error.HTTPError as err:
            return err.code, err.read().decode()

    log_path = work / "service_entry.log"
    t0 = time.monotonic()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen([sys.executable, "-m", "downloader_tpu_torch"],
                                cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            health = None
            while health is None:
                if proc.poll() is not None or time.monotonic() - t0 > 120:
                    raise RuntimeError("the service did not answer: "
                                       + log_path.read_text()[-2000:])
                try:
                    health = get("/health")
                except (urllib.error.URLError, ConnectionError):
                    time.sleep(0.2)
            up = time.monotonic() - t0
            status, text = get("/metrics")
            series = [line for line in text.splitlines()
                      if "frames_upscaled_total" in line
                      and not line.startswith("#")]
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = log_path.read_text()
    if (health[0] != 500 or "Not Running Jobs" not in health[1]
            or status != 200 or not series or rc != 0
            or "upscale stage enabled" not in out
            or "shutdown complete" not in out):
        raise AssertionError(f"service entry point: /health {health}, "
                             f"/metrics {status} {series}, exit {rc}: {out[-2000:]}")
    _say(f"python -m downloader_tpu_torch (the service): answered /health "
         f"{health[0]} {health[1].strip()} after {up:.2f} s, /metrics "
         f"{series[0]!r}; SIGTERM -> 'shutdown complete', exit {rc}")


def phase_service(torch, launches, work: Path, card_line: str):
    """The staging service at full width: two concurrent 1080p jobs
    through ``build_service`` on one engine, each staged stream held
    byte for byte against the engine's own ``upscale_to``; then the
    no-argument entry point started, probed and stopped."""
    import asyncio

    clip = work / "service_src.y4m"
    with open(clip, "wb") as fh:
        _write_y4m(fh, FRAMES, WIDTH, HEIGHT, seed=13)
    result = asyncio.run(_drive_service(torch, launches, work, clip))
    engine = result.pop("engine")
    if result["converts"] != SERVICE_JOBS:
        raise AssertionError(f"service: {result['converts']} Convert messages")
    _say(f"service: {SERVICE_JOBS} jobs staged, {result['converts']} Convert "
         f"messages; frames_upscaled_total {result['frames_upscaled']:.0f}")
    if result["frames_upscaled"] != SERVICE_JOBS * FRAMES:
        raise AssertionError(f"frames_upscaled {result['frames_upscaled']}")
    want = io.BytesIO()
    with open(clip, "rb") as fh:
        frames = engine.upscale_to(fh, want)
    want = want.getvalue()
    for job, got in result["jobs"].items():
        hops = got["hops"]
        if (got["state"], got["workload"], got["done"]) != ("DONE", "UPSCALE", True):
            raise AssertionError(f"{job}: {got['state']} {got['workload']} "
                                 f"done={got['done']}")
        if got["staged"] != want:
            raise AssertionError(f"{job}: the staged stream ({len(got['staged'])} "
                                 f"bytes) differs from the engine's upscale_to "
                                 f"({len(want)} bytes)")
        if not {"h2d", "compute", "d2h"} <= set(hops):
            raise AssertionError(f"{job}: hop ledger {hops}")
        stages = got["stage_seconds"]
        _say(f"{job}: DONE, UPSCALE class, done marker; staged "
             f"{len(got['staged'])} bytes byte-identical to the engine's "
             f"upscale_to ({frames} frames); stage seconds "
             + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
             + f"; wall {sum(stages.values()):.3f} s; "
             f"{FRAMES / stages['upscale']:.2f} frames/s through the stage; "
             "engine hops " + ", ".join(
                 f"{h} {hops[h]['seconds']:.4f} s / {hops[h]['bytes']} B"
                 for h in ("h2d", "compute", "d2h")) + f" ({card_line})")
    _say(f"service: {SERVICE_JOBS * FRAMES} frames of {WIDTH}x{HEIGHT} in "
         f"{result['wall']:.3f} s from publish to the last ack, "
         f"{SERVICE_JOBS * FRAMES / result['wall']:.2f} frames/s end to end "
         f"through the service, two jobs at once ({card_line})")
    del engine
    torch.cuda.empty_cache()
    _service_entry_point(work)


# phase 14's functions: the isolation test runs their imports in a fresh
# interpreter and requires no JAX and nothing of the JAX package
OPERATOR_FUNCTIONS = ("phase_operator", "_drive_operator", "_operator_cli")
OPERATOR_JOB = "operator-1"
OPERATOR_UPSCALE = {"enabled": True}  # UpscalerConfig(), batch 8, on the card


def _tests_on_path() -> None:
    """The repo's ``tests/`` on ``sys.path``, as ``bench.py`` puts it: the
    port's broker copy lives there."""
    tests = str(REPO / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)


async def _operator_cli(env: dict, *args: str) -> tuple:
    """``python -m downloader_tpu_torch <args>`` in a subprocess, as an
    operator runs it (never blocking the loop that serves the broker, the
    origin and the service): its wall from start to exit, stdout and
    stderr.  A non-zero exit raises."""
    import asyncio

    t0 = time.monotonic()
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "downloader_tpu_torch", *args, cwd=REPO, env=env,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
    try:
        async with asyncio.timeout(300):
            out, err = await proc.communicate()
    finally:
        if proc.returncode is None:
            proc.kill()
            await proc.wait()
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"operator command {' '.join(args)} exited "
                           f"{proc.returncode}: {err.decode()[-2000:]}")
    return wall, out.decode(), err.decode()


async def _drive_operator(launches, work: Path, clip: Path) -> dict:
    """One job of ``clip`` submitted with the port's CLI to the port's
    service, running in this process on the port's broker copy, then read
    back through the CLI's control-API commands and the store."""
    import asyncio

    from aiohttp import web

    from downloader_tpu_torch import schemas
    from downloader_tpu_torch.app import build_service
    from downloader_tpu_torch.control.registry import DONE, TERMINAL_STATES
    from downloader_tpu_torch.health import start_server
    from downloader_tpu_torch.platform.config import ConfigNode
    from downloader_tpu_torch.stages.upload import parse_done_marker
    from downloader_tpu_torch.store.fs import FilesystemObjectStore
    from test_torch_miniamqp import MiniAmqpServer

    body = clip.read_bytes()

    async def serve(_request):
        return web.Response(body=body)

    app = web.Application()
    app.router.add_get("/clip.y4m", serve)
    origin = web.AppRunner(app)
    await origin.setup()
    site = web.TCPSite(origin, "127.0.0.1", 0)
    await site.start()
    uri = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}/clip.y4m"
    broker = await MiniAmqpServer().start()
    conf = work / "operator_config"
    conf.mkdir()
    (conf / "converter.yaml").write_text(
        f'rabbitmq: {{backend: amqp}}\nservices: {{rabbitmq: "{broker.url}"}}\n')
    env = dict(os.environ, CONFIG_PATH=str(conf))
    store = FilesystemObjectStore(str(work / "operator_store"))
    config = ConfigNode({
        "instance": {"download_path": str(work / "operator_downloads"),
                     "upscale": OPERATOR_UPSCALE},
        "rabbitmq": {"backend": "amqp"},
        "services": {"rabbitmq": broker.url},
    })
    orchestrator, metrics, _telemetry = build_service(config, None, store)
    runner = None
    try:
        await orchestrator.start()
        runner = await start_server(orchestrator, metrics, port=0)
        url = f"http://127.0.0.1:{runner.addresses[0][1]}"
        result = {"startup": (await _operator_cli(env, "status", "--help"))[0]}
        # 2 tail launches: 16 frames at batch 8
        with launches.path("operator", _s2d_cores(FRAMES // 8)):
            result["submit_wall"], result["submit"], _ = await _operator_cli(
                env, "submit", "--id", OPERATOR_JOB, "--name", "Operator clip",
                "--uri", uri, "--wait")
        # the Convert goes out before the record settles
        record = orchestrator.registry.get(OPERATOR_JOB)
        async with asyncio.timeout(30):
            while record.state not in TERMINAL_STATES:
                await asyncio.sleep(0.02)
        if record.state != DONE:
            raise AssertionError(f"operator job settled {record.state}")
        result["status"] = (await _operator_cli(env, "status", "--url", url))[1]
        result["show"] = json.loads((await _operator_cli(
            env, "jobs", "show", OPERATOR_JOB, "--url", url))[1])
        result["events"] = (await _operator_cli(
            env, "jobs", "events", OPERATOR_JOB, "--url", url))[1]
        result["trace"] = (await _operator_cli(
            env, "trace", "show", result["show"]["traceId"], "--url", url))[1]
        result["incidents"] = (await _operator_cli(
            env, "incident", "list", "--url", url))[1]
        marker = await store.get_object("triton-staging",
                                        f"{OPERATOR_JOB}/original/done")
        result["done"] = parse_done_marker(marker)["done"]
        result["staged"] = await store.get_object(
            "triton-staging", f"{OPERATOR_JOB}/original/"
            + base64.b64encode(b"clip.2x.y4m").decode())
        result["converts"] = len(broker.published(schemas.CONVERT_QUEUE))
        result["frames_upscaled"] = metrics.frames_upscaled._value.get()
        result["engine"] = orchestrator.stage_resources["upscale.engine"]
    finally:
        if runner is not None:
            await runner.cleanup()
        await orchestrator.shutdown(grace_seconds=30)
        await broker.stop()
        await origin.cleanup()
    return result


def phase_operator(torch, launches, work: Path, card_line: str):
    """The operator surface at full width: a 1080p job submitted with the
    port's CLI runs through the port's service and engine; the CLI's
    control-API commands read it back, and the staged stream is held byte
    for byte against the engine's own ``upscale_to``."""
    import asyncio

    t_phase = time.monotonic()
    _tests_on_path()
    clip = work / "operator_src.y4m"
    with open(clip, "wb") as fh:
        _write_y4m(fh, FRAMES, WIDTH, HEIGHT, seed=14)
    result = asyncio.run(_drive_operator(launches, work, clip))
    engine = result.pop("engine")
    show, events, trace = result["show"], result["events"], result["trace"]
    stages, hops = show.get("stageSeconds") or {}, show.get("hopLedger") or {}
    if f"{OPERATOR_JOB} staged (Convert published)" not in result["submit"]:
        raise AssertionError(f"submit --wait printed {result['submit']!r}")
    if "health: idle" not in result["status"]:
        raise AssertionError(f"status printed {result['status']!r}")
    if (show.get("state") != "DONE" or "upscale" not in stages
            or not {"h2d", "compute", "d2h"} <= set(hops)):
        raise AssertionError(f"jobs show: {json.dumps(show)[:2000]}")
    if not any(line.split("\t")[1:2] == ["upscale"]
               and f" frames={FRAMES} " in line for line in events.splitlines()):
        raise AssertionError(f"jobs events: {events[-2000:]}")
    if "\tspan\tstage.upscale\t" not in trace:
        raise AssertionError(f"trace show: {trace[-2000:]}")
    if result["incidents"].strip():
        raise AssertionError(f"incident list: {result['incidents']!r}")
    if (result["done"], result["converts"], result["frames_upscaled"]) != (
            True, 1, FRAMES):
        raise AssertionError(f"operator job: done marker {result['done']}, "
                             f"{result['converts']} Convert messages, "
                             f"frames_upscaled {result['frames_upscaled']}")
    want = io.BytesIO()
    with open(clip, "rb") as fh:
        frames = engine.upscale_to(fh, want)
    if result["staged"] != want.getvalue():
        raise AssertionError(f"operator job: the staged stream "
                             f"({len(result['staged'])} bytes) differs from the "
                             f"engine's upscale_to ({len(want.getvalue())} bytes)")
    _say(f"operator: submit --wait exited 0 after {result['submit_wall']:.3f} s "
         f"(the CLI's start to its exit, {FRAMES} frames of {WIDTH}x{HEIGHT}); "
         f"the CLI starts in {result['startup']:.3f} s (status --help); "
         f"status, jobs show, jobs events, trace show and incident list "
         f"exited 0 ({card_line})")
    _say(f"operator: {OPERATOR_JOB} DONE, done marker, 1 Convert, "
         f"frames_upscaled_total {result['frames_upscaled']:.0f}; staged "
         f"{len(result['staged'])} bytes byte-identical to the engine's "
         f"upscale_to ({frames} frames); stage seconds "
         + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
         + f"; {FRAMES / stages['upscale']:.2f} frames/s through the stage; "
         "engine hops " + ", ".join(
             f"{h} {hops[h]['seconds']:.4f} s / {hops[h]['bytes']} B"
             for h in ("h2d", "compute", "d2h")) + f" ({card_line})")
    del engine
    torch.cuda.empty_cache()
    _say(f"operator phase: {time.monotonic() - t_phase:.1f} s")


# the (data x model) step on a one-rank NCCL group against the plain
# step: the same convs and Adam, with collectives over one rank between
MESH_LOSS_RTOL = 1e-3
MESH_STEPS, MESH_BATCH, MESH_CROP = 3, 8, 64
MESH_STREAM = 128  # frames of phase 15's frames/s stream


def _mesh_train_steps(steps: int, batch: int, crop: int, seed: int) -> dict:
    """On the current one-rank NCCL group: ``steps`` steps of the mesh
    step on a 1x1 plan and of the plain step, from one seeded init, on
    the same seeded batches; then ms per step of each, in turns."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
    from downloader_tpu_torch.compute.parallel.mesh import make_mesh, shard_batch
    from downloader_tpu_torch.compute.train import compile_train_step, make_train_step
    from downloader_tpu_torch.compute.trainer import box_downsample

    plan = make_mesh(model_axis=1)
    step, init_state, used = compile_train_step(UpscalerConfig(), mesh=plan)
    plain_step, plain_init = make_train_step(UpscalerConfig())
    state, plain = init_state(seed), plain_init(seed)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(steps):
        hr = rng.random((batch, crop, crop, 3), dtype=np.float32)
        batches.append((box_downsample(hr, 2).astype(np.float32), hr))
    mesh_losses, plain_losses = [], []
    for lr, hr in batches:
        mesh_losses.append(float(step(state, *shard_batch(plan, (lr, hr)))))
        plain_losses.append(float(plain_step(
            plain, torch.from_numpy(lr).cuda(), torch.from_numpy(hr).cuda())))
    lr, hr = (torch.from_numpy(a).cuda() for a in batches[0])
    ms = {"mesh": [], "plain": []}
    for name in ("plain", "mesh", "mesh", "plain"):
        fn, st = (step, state) if name == "mesh" else (plain_step, plain)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(10):
            fn(st, lr, hr)
        torch.cuda.synchronize()
        ms[name].append((time.monotonic() - t0) * 100.0)
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "plan": used.shape,
            "mesh": mesh_losses, "plain": plain_losses,
            "mesh_ms": min(ms["mesh"]), "plain_ms": min(ms["plain"])}


def phase_mesh(torch, launches, work: Path, fps: dict):
    """The multi-device path: the engine over every visible card and over
    the first card listed twice, byte for byte against the one-card
    engine; the (data x model) step on a one-rank NCCL group against the
    plain step; ``dryrun_multichip``; the overlap probe's alarm."""
    from downloader_tpu_torch.compute.overlap_probe import measure_overlap
    from downloader_tpu_torch.compute.parallel.group import COLLECTIVE_TIMEOUT
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler
    from downloader_tpu_torch.graft_entry import dryrun_multichip

    import numpy as np

    t_phase = time.monotonic()
    cards = torch.cuda.device_count()
    data = (work / "src.y4m").read_bytes()  # phase 5's 16-frame 1080p clip

    def stream(engine, src: bytes) -> bytes:
        out = io.BytesIO()
        if engine.upscale_to(io.BytesIO(src), out) != FRAMES:
            raise AssertionError(f"upscale_to wrote another count than {FRAMES}")
        return out.getvalue()

    single = FrameUpscaler(use_mesh=False)
    want = stream(single, data)
    every = FrameUpscaler()
    twice = FrameUpscaler(batch=16, devices=["cuda:0", "cuda:0"])
    if every.n_devices != cards or twice.n_devices != 2:
        raise AssertionError(f"engines over {every.n_devices} and "
                             f"{twice.n_devices} devices")
    for name, engine in (("mesh_every_card", every), ("mesh_card_twice", twice)):
        dispatches = -(-FRAMES // engine.batch_for(HEIGHT, WIDTH))
        calls = []
        dispatch = engine._dispatch

        def counted(*args, dispatch=dispatch, calls=calls):
            calls.append(args[0].shape[0])
            return dispatch(*args)

        engine._dispatch = counted
        try:
            with launches.path(name, _s2d_cores(engine.n_devices * dispatches)):
                got = stream(engine, data)
        finally:
            del engine._dispatch
        if got != want:
            diff = np.frombuffer(got, np.uint8) != np.frombuffer(want, np.uint8)
            raise AssertionError(f"{name}: {int(diff.sum())} bytes differ from "
                                 "the one-card engine's stream")
        if len(calls) != dispatches:
            raise AssertionError(f"{name}: {len(calls)} dispatches, want "
                                 f"{dispatches}")
        _say(f"{name}: {engine.n_devices} shards x {len(calls)} dispatches of "
             f"{engine.batch_for(HEIGHT, WIDTH)} frames ({sum(calls)} frames "
             f"read), stream byte-identical to the one-card engine's "
             f"({len(got)} bytes)")

    longer = io.BytesIO()
    _write_y4m(longer, MESH_STREAM, WIDTH, HEIGHT, seed=5, distinct=16)
    longer = longer.getvalue()
    walls = {"one card": [], "card twice": []}
    for name in ("one card", "card twice", "card twice", "one card"):
        engine = single if name == "one card" else twice
        t0 = time.monotonic()
        engine.upscale_to(io.BytesIO(longer), _Sink())
        walls[name].append(time.monotonic() - t0)
    _say(f"1080p frames/s through upscale_to, {MESH_STREAM} frames, best of 2 "
         "in turns: " + ", ".join(f"{k} {MESH_STREAM / min(v):.2f}"
                                  for k, v in walls.items())
         + f"; phase 11's one-card engine: {fps.get('1080p', float('nan')):.2f}")
    del single, every, twice
    torch.cuda.empty_cache()

    # the mesh step in this process, on a one-rank NCCL group (the
    # spawned-group path runs in dryrun_multichip below)
    import torch.distributed as dist

    t0 = time.monotonic()
    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                          timeout=COLLECTIVE_TIMEOUT)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        res = _mesh_train_steps(MESH_STEPS, MESH_BATCH, MESH_CROP, 0)
    finally:
        dist.destroy_process_group()
    worst = max(abs(a - b) / abs(b) for a, b in zip(res["mesh"], res["plain"]))
    _say(f"one-rank {res['backend']} group (world {res['world']}), plan "
         f"{res['plan']}: {MESH_STEPS} steps at batch "
         f"{MESH_BATCH} crop {MESH_CROP}, mesh losses "
         f"{', '.join(f'{x:.6f}' for x in res['mesh'])} vs plain "
         f"{', '.join(f'{x:.6f}' for x in res['plain'])} (worst rel {worst:.2e}); "
         f"{res['mesh_ms']:.3f} ms/step mesh vs {res['plain_ms']:.3f} plain "
         f"({time.monotonic() - t0:.1f} s with the group's start)")
    if res["backend"] != "nccl" or worst > MESH_LOSS_RTOL:
        raise AssertionError(f"mesh step vs plain: {res}")

    t0 = time.monotonic()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = dryrun_multichip(cards)
    if not line.startswith("dryrun_multichip ok: "):
        raise AssertionError(f"dryrun_multichip printed {out.getvalue()!r}")
    _say(f"{line} ({time.monotonic() - t0:.1f} s with process start)")

    engine = FrameUpscaler()
    last = None
    for attempt in range(3):
        last = measure_overlap(engine, height=720, width=1280, frame_interval=0.003)
        _say(f"overlap probe at 720p, 3 ms a frame, attempt {attempt + 1}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in last.items()))
        if last["overlap"] >= 0.5 and last["pipelined_s"] <= 0.85 * last["serial_s"]:
            break
    else:
        raise AssertionError(f"overlap probe: {last}")
    del engine
    torch.cuda.empty_cache()
    _say(f"mesh phase: {time.monotonic() - t_phase:.1f} s")


def phase_lint() -> None:
    """The port's graftlint gate over its walk, as ``make lint`` runs it."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "downloader_tpu_torch.analysis", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        raise AssertionError(f"graftlint exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout)
    if report["findings"] != []:
        raise AssertionError(f"graftlint: {report}")
    _say(f"lint: 0 findings, {report['suppressed']} suppressed, "
         f"{report['files']} files, analyzer {report['duration_s']:.3f} s "
         f"({wall:.2f} s with interpreter start), Python "
         f"{sys.version.split()[0]}")


ORBAX_FIXTURE = REPO / "downloader_tpu_torch" / "compute" / "orbax_reader" / "testdata"
FOREIGN = ("orbax", "tensorstore", "zstandard", "jax")


def _orbax_read(work: Path, card_line: str) -> Path:
    """The committed JAX step read on the card's host: no orbax,
    tensorstore, zstandard or JAX loaded, every array's sha256 the
    manifest's; a copy of the step directory is returned."""
    import hashlib
    import importlib.util

    from downloader_tpu_torch.compute import checkpoint
    from downloader_tpu_torch.compute.orbax_reader.step import read_step

    installed = [m for m in FOREIGN if importlib.util.find_spec(m) is not None]
    _say(f"orbax: installed on this host: {installed or 'none'} of {list(FOREIGN)}")
    ckpt = work / "orbax_ckpt"
    shutil.copytree(ORBAX_FIXTURE / "ckpt", ckpt)
    manifest = json.loads((ORBAX_FIXTURE / "manifest.json").read_text())
    step_dir = ckpt / str(manifest["step"])
    size = sum(f.stat().st_size for f in step_dir.rglob("*") if f.is_file())
    t0 = time.perf_counter()
    tree = read_step(str(step_dir))
    seconds = time.perf_counter() - t0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)
    if loaded:
        raise AssertionError(f"reading the orbax step loaded {loaded}")
    if checkpoint.latest_step(ckpt) != 3 or manifest["step"] != 3:
        raise AssertionError(f"orbax fixture: latest step {checkpoint.latest_step(ckpt)}")

    def leaves(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                yield from leaves(value, prefix + (key,))
            elif value is not None:
                yield "/".join(prefix + (key,)), value

    arrays = dict(kv for item in ("params", "opt_state")
                  for kv in leaves(tree[item], (item,)))
    if set(arrays) != set(manifest["arrays"]):
        raise AssertionError(f"orbax fixture arrays {sorted(arrays)}")
    for name, value in arrays.items():
        if hashlib.sha256(value.tobytes()).hexdigest() != manifest["arrays"][name]["sha256"]:
            raise AssertionError(f"orbax fixture: {name} differs from the manifest")
    values = sum(v.size for v in arrays.values())
    _say(f"orbax: read step 3 of UpscalerConfig() ({size} bytes on disk, "
         f"{len(arrays)} arrays, {values} values) in {seconds:.3f} s, "
         f"{size / seconds / 1e6:.3f} MB/s on the card's host, {card_line}; "
         f"every array's sha256 is the manifest's; loaded of {list(FOREIGN)}: none")
    return ckpt


def phase_orbax(torch, launches, card_line: str):
    """The JAX package's model on the card: the committed orbax step read
    without orbax, served by the ``upscale`` CLI (against the JAX
    package's committed CPU output) and on phase 5's 1080p stream
    (counted), then its run resumed by the ``train`` CLI on the card and
    on the CPU."""
    import numpy as np

    from downloader_tpu_torch.compute.pipeline import FrameUpscaler

    t_phase = time.monotonic()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_orbax_", dir=REPO))
    try:
        ckpt = _orbax_read(work, card_line)
        out = work / "clip.2x.y4m"
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "downloader_tpu_torch", "upscale",
             str(ORBAX_FIXTURE / "clip.y4m"), str(out), "--checkpoint-dir", str(ckpt)],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"upscale CLI --checkpoint-dir <orbax> exited "
                               f"{proc.returncode}: {proc.stderr[-2000:]}")
        _say(f"python -m downloader_tpu_torch upscale --checkpoint-dir <orbax step>: "
             f"{proc.stdout.strip()} ({time.monotonic() - t0:.2f} s with process start)")
        (_, got), (_, want) = _read_y4m(out), _read_y4m(ORBAX_FIXTURE / "clip.2x.y4m")
        _card_vs_cpu("orbax model vs the JAX package's committed output",
                     [np.stack([f[i] for f in got]) for i in range(3)],
                     [np.stack([f[i] for f in want]) for i in range(3)], chip_bound=True)

        src = work / "src.y4m"
        with open(src, "wb") as fh:
            _write_y4m(fh, FRAMES, WIDTH, HEIGHT, seed=3)  # phase 5's stream
        data = src.read_bytes()
        engine = FrameUpscaler(checkpoint_dir=str(ckpt))
        engine.upscale_to(io.BytesIO(data), _Sink())  # warm-up
        with launches.path("orbax", _s2d_cores(FRAMES // 8)):
            t0 = time.perf_counter()
            frames = engine.upscale_to(io.BytesIO(data), _Sink())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if frames != FRAMES:
            raise AssertionError(f"orbax model upscaled {frames} frames")
        _say(f"orbax model: {FRAMES} frames of {WIDTH}x{HEIGHT} through upscale_to "
             f"in {wall:.3f} s, {FRAMES / wall:.2f} frames/s (after one warm-up "
             f"stream), {card_line}")
        del engine
        torch.cuda.empty_cache()

        media = work / "train_media"
        media.mkdir()
        with open(media / "clip.y4m", "wb") as fh:   # phase 12's clip
            _write_training_clip(fh, TRAIN_FRAMES, TRAIN_WIDTH, TRAIN_HEIGHT, seed=21)
        cpu_ckpt = work / "orbax_ckpt_cpu"
        shutil.copytree(ckpt, cpu_ckpt)
        runs = {}
        for where, directory, extra in (("card", ckpt, []),
                                        ("CPU", cpu_ckpt, ["--device", "cpu"])):
            lines = _train_cli(["--data", media, "--steps", 3, "--checkpoint-dir",
                                directory, *extra], f"orbax resume, {where}")
            kept = sorted(os.listdir(directory), key=int)
            if (lines[0] != "resumed from step 3" or "trained to step 6" not in lines[-1]
                    or kept != ["3", "6"] or not (directory / "3" / "params").is_dir()
                    or not (directory / "6" / "state.pt").is_file()):
                raise AssertionError(f"train CLI orbax resume ({where}): {lines[0]!r}, "
                                     f"{lines[-1]!r}, steps kept {kept}")
            runs[where] = {**_logged_losses(lines),
                           6: float(lines[-1].split("(loss ")[1].split(",")[0])}
        rel = {s: abs(runs["card"][s] - runs["CPU"][s]) / runs["CPU"][s]
               for s in runs["CPU"]}
        _say("orbax resume, steps 4 and 6 (batch 8 crop 64): card "
             + ", ".join(f"{runs['card'][s]:.6f}" for s in sorted(rel)) + "; CPU "
             + ", ".join(f"{runs['CPU'][s]:.6f}" for s in sorted(rel))
             + "; relative " + ", ".join(f"{rel[s]:.3e}" for s in sorted(rel))
             + f" (bound {TRAIN_LOSS_RTOL[0]:g}); each directory holds orbax step 3 "
             "and the port's step 6")
        if sorted(rel) != [4, 6] or max(rel.values()) > TRAIN_LOSS_RTOL[0]:
            raise AssertionError(f"orbax resume card vs CPU: relative {rel}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _say(f"orbax phase: {time.monotonic() - t_phase:.1f} s")


SWINIR_BATCHES, SWINIR_SEED = 2, 2**31 + 27


def _kernel_times(torch, prof) -> list:
    """(device ms, launches, name) of the profiled kernels, longest
    first."""
    rows = []
    for event in prof.key_averages():
        ms = getattr(event, "device_time_total", getattr(event, "cuda_time_total", 0)) / 1e3
        if ms > 0 and event.count:
            rows.append((ms, event.count, event.key))
    return sorted(rows, reverse=True)


def phase_swinir(torch, launches):
    """Phase 18 (module docstring): the second architecture through the
    engine, against the benchmark's plain reference."""
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler
    from portbench.reference import swinir as reference
    from portbench.seeded import frames
    from portbench.traffic.stream import compare
    from portbench.traffic.stream_arch import swinir_config, swinir_weights

    t_phase = time.monotonic()
    config = json.loads((REPO / "portbench" / "configs" / "swinir-m-x4-real.json")
                        .read_text())
    cell = json.loads((REPO / "portbench" / "workloads" / "swinir-x4-540p-stream.json")
                      .read_text())
    limits = {k: v["limit"] for k, v in cell["checks"].items()}
    width, height, batch = 960, 540, config["batch"]
    weights = swinir_weights(config, SWINIR_SEED, "cuda")
    engine = FrameUpscaler(swinir_config(config), batch=batch, params=weights)
    planes = frames(SWINIR_BATCHES * batch, height, width, 2, SWINIR_SEED + 1, "cuda")
    host = [p.cpu().numpy() for p in planes]
    torch.cuda.reset_peak_memory_stats()
    outs, times = [], []
    with launches.path("swinir", {"quantize_u8": 3 * SWINIR_BATCHES}):
        for b in range(SWINIR_BATCHES):
            rows = slice(b * batch, (b + 1) * batch)
            t0 = time.monotonic()
            outs.append(engine.upscale_batch(*(p[rows] for p in host), 2, 2))
            times.append(time.monotonic() - t0)
    peak = torch.cuda.max_memory_allocated()
    if outs[0][0].shape != (batch, 4 * height, 4 * width):
        raise AssertionError(f"swinir output {outs[0][0].shape}")
    _say(f"swinir: {SWINIR_BATCHES} batches of {batch} 960x540 -> 3840x2160 in "
         + ", ".join(f"{t:.3f}" for t in times) + f" s; peak {peak / 2**30:.2f} GiB")
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        engine.upscale_batch(*(p[:batch] for p in host), 2, 2)
        torch.cuda.synchronize()
    kernels = _kernel_times(torch, prof)
    attention = [k for k in kernels if any(tag in k[2].lower() for tag in (
        "fmha", "flash", "attention", "sdpa", "attn"))]
    _say("swinir top device ops (ms, launches, name): "
         + json.dumps([(round(ms, 3), n, name[:120]) for ms, n, name in kernels[:12]]))
    if not attention:
        raise AssertionError("no attention kernel in the profiled batch")
    for ms, n, name in attention:
        _say(f"swinir attention kernel: {name} ({n} launches per batch, {ms:.2f} ms)")
    del engine
    torch.cuda.empty_cache()
    worst = {"worst_mae": 0.0, "worst_step": 0.0}
    for b in range(SWINIR_BATCHES):
        for i in (0, batch - 1):
            j = b * batch + i
            want = reference.upscale(weights, *(p[j:j + 1] for p in planes), config)
            gaps = compare([o[i] for o in outs[b]], [w[0].cpu().numpy() for w in want])
            worst = {k: max(worst[k], gaps[k]) for k in worst}
    _say(f"swinir vs the plain reference: {worst} (limits {limits})")
    if any(worst[k] > limits[k] for k in worst):
        raise AssertionError(f"swinir outside the cell's limits: {worst}")
    _swinir_attention_matters(torch, config, weights, planes)
    _say(f"swinir phase: {time.monotonic() - t_phase:.1f} s")


def _swinir_attention_matters(torch, config: dict, weights: dict, planes) -> None:
    """Phase 18's second check (module docstring): one frame on weights
    where the bias and the shift mask move the output."""
    import dataclasses

    _tests_on_path()
    import plain_swinir
    from downloader_tpu_torch.compute.models import build_model
    from downloader_tpu_torch.compute.pipeline import no_tf32
    from portbench.reference.upscaler import unit_rgb
    from portbench.traffic.stream_arch import swinir_config

    device = planes[0].device
    g = torch.Generator(device=device).manual_seed(SWINIR_SEED + 2)
    sharp = dict(weights)
    for name, value in weights.items():
        if name.endswith("relative_position_bias_table"):
            sharp[name] = torch.randn(value.shape, generator=g, device=device) * 2.0
        elif name.endswith("attn.qkv.weight"):
            sharp[name] = torch.randn(value.shape, generator=g,
                                      device=device) / math.sqrt(value.shape[1])
    cfg = swinir_config(config)
    model = build_model(cfg)
    model.load_state_dict(sharp)
    model = model.to(device).eval()
    rgb = unit_rgb(*(p[:1] for p in planes))
    with torch.inference_mode():
        port = model(rgb.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    del model
    plain = dataclasses.asdict(dataclasses.replace(cfg, compute_dtype=torch.float32))

    def reference(leave_out=()):
        with no_tf32(), torch.inference_mode():
            return plain_swinir.forward(sharp, rgb, plain, leave_out)

    def gap(a, b):
        d = (a - b).abs().mean(1, keepdim=True)
        return torch.nn.functional.avg_pool2d(d, 32, ceil_mode=True).max().item()

    want = reference()
    gaps = {"port": gap(port, want),
            "bias_left_out": gap(reference(["bias"]), want),
            "shift_mask_left_out": gap(reference(["shift_mask"]), want)}
    _say(f"swinir at bias std 2, unit-gain qkv (worst 32x32-tile mean gap to the "
         f"plain reference, output std {want.std().item():.3f}): {gaps}")
    if gaps["port"] * 3 > min(gaps["bias_left_out"], gaps["shift_mask_left_out"]):
        raise AssertionError(f"swinir's attention on the card is not the reference's: "
                             f"{gaps}")


def _stack_planes(data: bytes, batch: int):
    """The first ``batch`` frames of a Y4M stream as stacked planes."""
    import numpy as np

    from downloader_tpu_torch.compute.video import Y4MReader

    frames = [f for f, _ in zip(Y4MReader(io.BytesIO(data)), range(batch))]
    return [np.stack([f[i] for f in frames]) for i in range(3)]


def main(argv=()) -> int:
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

    from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
    from downloader_tpu_torch.compute.ops.colorspace import fused_subpixel_ycc_s2d
    from downloader_tpu_torch.compute.ops.conv_epilogue import conv_epilogue
    from downloader_tpu_torch.compute.ops.pixel_shuffle import quantize_u8
    from downloader_tpu_torch.compute.ops.s2d_head import s2d_head_kernel

    # every kernel with its wrapper (whose launch counter the paths read),
    # its source and the TPU kernel it replaces
    kernels_of = {
        "quantize_u8": (quantize_u8, "quantize_u8.cu",
                        "downloader_tpu/compute/ops/pixel_shuffle.py:75"),
        "s2d_tail": (fused_subpixel_ycc_s2d, "s2d_tail.cu",
                     "downloader_tpu/compute/ops/pixel_shuffle.py:75"),
        "s2d_head": (s2d_head_kernel, "s2d_head.cu",
                     "scripts/pallas_head_spike.py:35"),
        # no Pallas kernel: XLA fused the bias, relu and residual into the conv
        "conv_epilogue": (conv_epilogue, "conv_epilogue.cu",
                          "downloader_tpu/compute/models/upscaler.py:75"),
    }
    if UpscalerConfig().depth != EPILOGUES_S2D:
        raise AssertionError(f"UpscalerConfig().depth is {UpscalerConfig().depth}: "
                             f"EPILOGUES_S2D ({EPILOGUES_S2D}) is stale")
    launches = _Launches(torch, {k: v[0] for k, v in kernels_of.items()})
    if list(argv) == ["swinir"]:
        phase_swinir(torch, launches)                           # 18
        _say(card_line)
        _say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
        return 0
    results: dict = {}
    phase_quantize(torch, rates, results)                       # 2
    phase_tail(torch, rates, results)                           # 3
    phase_head(torch, rates, results)                           # 4
    phase_epilogue(torch, rates, results)                       # 4b
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO))
    try:
        engine = phase_main_path(torch, launches, work)          # 5
        phase_spike(torch, launches)                            # 6
        phase_4k(torch, launches, work)                         # 7
        phase_generic(torch, launches, work)                    # 8
        phase_odd(torch, launches, work)                        # 9
        phase_scale1_s2d(torch, launches, work)                 # 9b
        phase_infer(torch, launches)                            # 10
        torch.cuda.empty_cache()
        fps = phase_throughput(torch, engine)                   # 11
        del engine
        torch.cuda.empty_cache()
        phase_train(torch, launches, work)                      # 12
        torch.cuda.empty_cache()
        phase_service(torch, launches, work, card_line)         # 13
        phase_operator(torch, launches, work, card_line)        # 14
        phase_mesh(torch, launches, work, fps)                  # 15
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_lint()                                                # 16
    phase_orbax(torch, launches, card_line)                     # 17
    torch.cuda.empty_cache()
    phase_swinir(torch, launches)                               # 18

    line = {"kernels": []}
    for k, (_, source, replaces) in kernels_of.items():
        by_path = {path: counts[k] for path, counts in launches.by_path.items()}
        if not any(by_path.values()):
            raise AssertionError(f"kernel {k} launched on no driven path")
        line["kernels"].append({
            "name": k, "route": "cuda",
            "source": f"downloader_tpu_torch/compute/csrc/{source}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **{key: results[k][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}})
    _say(f"total {time.monotonic() - t_start:.1f} s")
    _say(card_line)
    _say(json.dumps(line))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
