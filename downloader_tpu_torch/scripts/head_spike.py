"""The hand-written s2d-head kernel against the engine's cuDNN head — the
counterpart of the JAX package's Pallas spike
(``scripts/pallas_head_spike.py``, ``check|race``):

    python -m downloader_tpu_torch.scripts.head_spike check [--device cpu]
    python -m downloader_tpu_torch.scripts.head_spike race

Both modes build the packed ``k4``/``bias4`` from the engine's seeded
``subpixel`` params through :func:`pack_s2d_kernel`, as the spike does.

- ``check`` runs :func:`s2d_head_kernel` and the engine's
  :func:`s2d_head` on seeded (2, 64, 256, 128) bf16 features and prints
  the spike's three lines: the shapes, the max |diff| and the exact
  share.  The two differ by up to one bf16 ulp: the kernel rounds once
  after adding the bias in f32, ``s2d_head`` rounds the conv and then the
  bias add.  ``--device cpu`` runs the kernel's plain version instead.
- ``race`` times both heads with CUDA events, interleaved, at the spike's
  (8, 720, 1280, 128) and the 1080p main path's (8, 1080, 1920, 128).
  It needs the card.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

from ..compute.ops.s2d_head import pack_s2d_kernel, s2d_head, s2d_head_kernel
from ..compute.pipeline import FrameUpscaler

CHECK_SHAPE = (2, 64, 256, 128)
RACE_SHAPES = ((8, 720, 1280, 128), (8, 1080, 1920, 128))


def head_params(engine: FrameUpscaler):
    """The engine's plain head as (HWIO kernel, bias) and packed as
    (k4, bias4) in bf16, contiguous, as the kernel takes them."""
    head = engine.model.subpixel
    kernel = head.weight.permute(2, 3, 1, 0)
    k4 = pack_s2d_kernel(kernel).to(torch.bfloat16).contiguous()
    bias4 = head.bias.repeat(4).to(torch.bfloat16)
    return kernel, head.bias, k4, bias4


def check(engine: FrameUpscaler) -> None:
    kernel, bias, k4, bias4 = head_params(engine)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal(CHECK_SHAPE).astype(np.float32)
                             ).to(torch.bfloat16).to(engine.device)
    want = s2d_head(feats, kernel, bias)
    got = s2d_head_kernel(feats, k4, bias4)
    w32, g32 = want.float().cpu(), got.float().cpu()
    print("shapes:", tuple(want.shape), tuple(got.shape))
    print("max |diff|:", float((w32 - g32).abs().max()))
    print("exact frac:", float((w32 == g32).double().mean()))


def _event_ms(fn, reps: int) -> float:
    """Median device ms of one call over ``reps`` back-to-back calls."""
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def race(engine: FrameUpscaler, rounds: int = 4, reps: int = 10) -> None:
    kernel, bias, k4, bias4 = head_params(engine)
    gen = torch.Generator(device=engine.device).manual_seed(0)
    for shape in RACE_SHAPES:
        feats = torch.randn(shape, generator=gen, device=engine.device,
                            dtype=torch.bfloat16)
        variants = {
            "cudnn_head": lambda: s2d_head(feats, kernel, bias),
            "kernel_head": lambda: s2d_head_kernel(feats, k4, bias4),
        }
        for fn in variants.values():  # build, warm up
            fn()
        torch.cuda.synchronize()
        best = {name: float("inf") for name in variants}
        for _ in range(rounds):
            for name, fn in variants.items():
                best[name] = min(best[name], _event_ms(fn, reps))
        for name, ms in best.items():
            print(f"{shape} {name}: {ms:7.3f} ms")
        del feats


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="head_spike", description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", nargs="?", choices=("check", "race"),
                        default="check")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cpu runs check on the kernel's plain version")
    args = parser.parse_args(argv)
    if args.mode == "race" and args.device != "cuda":
        parser.error("race times the card: it needs --device cuda")
    engine = FrameUpscaler(batch=8, device=args.device)
    print("device:", torch.cuda.get_device_name(engine.device)
          if engine.device.type == "cuda" else "cpu", flush=True)
    with torch.inference_mode():
        (check if args.mode == "check" else race)(engine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
