"""The benchmark's frozen arithmetic: data-sheet peaks, the model's
operation count and the least time a kernel can take.  Copied from the
program once and kept here, so that the yardstick does not move when
the program changes."""

from __future__ import annotations

# NVIDIA's data sheets, dense rates without sparsity, by a substring of
# ``torch.cuda.get_device_name()``; first match wins (the SXM H100
# reports no form factor in its name): memory bytes/s, non-tensor f32
# FLOP/s, bf16 tensor-core FLOP/s
CARDS = [
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H200", 4.8e12, 67e12, 989e12),
    ("H100", 3.35e12, 67e12, 989e12),
]


def card_rates(name: str):
    """(bytes/s, f32 FLOP/s, bf16 FLOP/s) of the card called ``name``."""
    for tag, *rates in CARDS:
        if tag in name:
            return tuple(rates)
    raise RuntimeError(f"no data-sheet rates for card {name!r}")


def least_seconds(nbytes: float, ops: float, rates, tensor: bool = False) -> float:
    """The least time for the work: bytes over the memory rate or
    operations over the peak of their kind, whichever is larger."""
    bandwidth, f32_rate, bf16_rate = rates
    return max(nbytes / bandwidth, ops / (bf16_rate if tensor else f32_rate))


def upscaler_flops_per_frame(config: dict, height: int, width: int) -> int:
    """Matmul-equivalent FLOPs of one plain forward on one (H, W) input
    frame: conv MACs x 2, with the plain 3x3 head whatever head runs;
    elementwise work and the colorspace are left out."""
    f, c, r = config["features"], config["channels"], config["scale"]
    pixels = height * width
    stem = 2 * pixels * 5 * 5 * c * f
    body = (config["depth"] - 1) * 2 * pixels * 3 * 3 * f * f
    head = 2 * pixels * 3 * 3 * f * (c * r * r)
    return stem + body + head


def s2d_tail_bytes(frames: int, height: int, width: int, scale: int) -> int:
    """Bytes the s2d tail must move for ``frames`` (H, W) input frames:
    the head's packed bf16 maps read once, u8 luma at scale and the two
    u8 chroma planes at the input's full size written once."""
    packed = frames * (height // 2) * (width // 2) * 12 * scale * scale * 2
    return packed + frames * height * width * (scale * scale + 2)


def quantize_bytes(elements: int) -> int:
    """Bytes a quantize of ``elements`` f32 values to u8 must move."""
    return elements * (4 + 1)
