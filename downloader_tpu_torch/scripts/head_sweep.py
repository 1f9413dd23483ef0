"""Sweep the s2d head kernel's tile, ring and group sizes on the card:

    python -m downloader_tpu_torch.scripts.head_sweep

``csrc/s2d_head.cu`` takes them as macros (``S2D_HEAD_M_TILES``: M = 64
tiles per warpgroup, so 4x that many output rows per tile;
``S2D_HEAD_WIN_STAGES``: window chunks in flight; ``S2D_HEAD_W_STAGES``:
weight steps in flight; ``S2D_HEAD_TAPS_PER_STEP``: taps per weight step;
``S2D_HEAD_TAPS_PER_GROUP``: taps per ``wgmma`` commit group).  Each
variant is built with ``-D`` into its own library, checked against the
plain head on a ragged shape (<= 1 bf16 ulp, >= 99% exact) and timed with
CUDA events at the race's (8, 720, 1280, 128) and (8, 1080, 1920, 128),
in interleaved rounds, beside cuDNN's conv + bias pass.  The defaults are
the shipped kernel.  It needs the card.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..compute import kernels
from ..compute.ops.s2d_head import repack_k4, s2d_head_kernel_plain
from .head_spike import RACE_SHAPES, _event_ms

# (S2D_HEAD_TAPS_PER_GROUP defaults to the whole step)
DEFAULTS = {"M_TILES": 2, "WIN_STAGES": 2, "W_STAGES": 4, "TAPS_PER_STEP": 4}
VARIANTS = [
    {},                                              # the shipped kernel
    {"TAPS_PER_GROUP": 1},                           # one group in flight
    {"TAPS_PER_GROUP": 2},                           #   while the next loads
    {"W_STAGES": 2},
    {"W_STAGES": 6},
    {"TAPS_PER_STEP": 2, "W_STAGES": 8},             # same bytes in flight
    {"M_TILES": 1},
    {"M_TILES": 1, "WIN_STAGES": 4},
]


def _tag(variant) -> str:
    return "_".join(f"{k.lower()}{v}" for k, v in {**DEFAULTS, **variant}.items())


def build(variants):
    """Compile every variant at once; return {tag: ctypes entry point}."""
    return kernels.build_variants("s2d_head", {
        _tag(v): {f"S2D_HEAD_{k}": x for k, x in {**DEFAULTS, **v}.items()}
        for v in variants})


def _runner(fn, feats, w16, bias4):
    b, h, w, _ = feats.shape
    out = torch.empty((b, h // 2, w // 2, 48), dtype=torch.bfloat16, device=feats.device)

    def run():
        kernels.launch(fn, "s2d_head", feats.device, feats.data_ptr(),
                       w16.data_ptr(), bias4.data_ptr(), out.data_ptr(), b, h, w, 0)
        return out
    return run


def _ulps(got, want):
    """|got - want| in bf16 ulps, magnitudes under RMS/256 at that floor
    (as chip_smoke.py and tests/test_torch_kernels.py count them)."""
    g, w = got.float(), want.float()
    floor = w.pow(2).mean().sqrt() / 256
    _, exp = torch.frexp(torch.maximum(w.abs(), floor))
    return (g - w).abs() / torch.ldexp(torch.ones_like(w), exp - 8)


def main() -> int:
    if not torch.cuda.is_available():
        print("head_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print("device:", torch.cuda.get_device_name(dev), flush=True)
    fns = build(VARIANTS)
    gen = torch.Generator(device=dev).manual_seed(0)
    k4 = (torch.randn((4, 4, 128, 48), generator=gen, device=dev) / 1152 ** 0.5
          ).bfloat16()
    bias4 = (torch.randn((48,), generator=gen, device=dev) * 0.1).bfloat16()
    w16 = repack_k4(k4)

    # correctness of every variant on a ragged shape
    feats = torch.randn((2, 34, 200, 128), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    want = s2d_head_kernel_plain(feats, k4, bias4)
    for tag, fn in fns.items():
        out = _runner(fn, feats, w16, bias4)()
        torch.cuda.synchronize()
        worst = float(_ulps(out, want).max())
        exact = float((out == want).double().mean())
        if worst > 1 or exact < 0.99:
            raise AssertionError(f"{tag}: {worst} ulp, exact {exact}")
    print(f"checked {len(fns)} variants: <= 1 bf16 ulp, >= 99% exact")

    for shape in RACE_SHAPES:
        feats = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
        x = feats.permute(0, 3, 1, 2)
        w_lib = k4.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        variants = {"cudnn conv + bias": lambda: F.conv2d(
            x, w_lib, None, stride=2, padding=1).permute(0, 2, 3, 1) + bias4}
        for tag, fn in fns.items():
            variants[tag] = _runner(fn, feats, w16, bias4)
        for fn in variants.values():
            fn()
        torch.cuda.synchronize()
        best = {name: float("inf") for name in variants}
        for _ in range(3):
            for name, fn in variants.items():
                best[name] = min(best[name], _event_ms(fn, 10))
        for name, ms in sorted(best.items(), key=lambda kv: kv[1]):
            print(f"{shape} {name}: {ms:.4f} ms")
        del feats, x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
