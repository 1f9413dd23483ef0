"""Space-to-depth head: the model's 3x3 sub-pixel projection as one
stride-2 4x4 conv with 4x the output channels.

A SAME 3x3 conv evaluated at the four positions of a 2x2 output block
reads a shared 4x4 input window.  Packing the four shifted 3x3 kernels
into one stride-2 4x4 conv computes exactly the same numbers —

    out3x3[b, 2i+di, 2j+dj, c] == out4x4[b, i, j, (di*2+dj)*C + c]

— with N = 4*C output channels (48 at scale 2).  The packed kernel is
built from the model's ordinary ``subpixel`` params, so checkpoints keep
the plain 3x3 head.

Two versions of the head live here:

- :func:`s2d_head` is the engine's head and runs on cuDNN, as the
  reference's engine left it to XLA's conv.  It rounds the conv to the
  compute dtype and then adds the bias in it: two roundings.
- :func:`s2d_head_kernel` is the port of the Pallas spike
  ``pallas_s2d_head`` (``scripts/pallas_head_spike.py:35-107``), a
  hand-written Hopper kernel (``csrc/s2d_head.cu``: TMA loads, ``wgmma``
  on bf16 with f32 accumulation): an f32 sum over the 16 taps, the bias
  added in f32, and ONE rounding.
  The two therefore differ by up to one bf16 ulp.  It runs on the spike's
  path (``scripts/head_spike.py``), not in the engine, which mirrors the
  JAX engine's two-rounding head.

Requires even H and W.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels

_CIN, _COUT = 128, 48  # the kernel's shape: the full-width model at scale 2


def pack_s2d_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(3, 3, Cin, C) HWIO SAME-conv kernel -> (4, 4, Cin, 4*C) stride-2
    packed kernel.  Output channel block g = di*2+dj holds the kernel
    shifted to sub-position (di, dj) — padded (di, 1-di) rows and
    (dj, 1-dj) columns; blocks never overlap, zeros fill the taps
    outside each 3x3 sub-window."""
    kh, kw = kernel.shape[:2]
    if (kh, kw) != (3, 3):
        raise ValueError(f"s2d packing expects a 3x3 kernel, got {kh}x{kw}")
    # F.pad lists (last dim, ..., first dim): O, I, W, H
    blocks = [
        F.pad(kernel, (0, 0, 0, 0, dj, 1 - dj, di, 1 - di))
        for di in (0, 1) for dj in (0, 1)
    ]
    return torch.cat(blocks, dim=-1)


def s2d_head(feats: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Apply the packed head: (B, H, W, Cin) NHWC -> (B, H/2, W/2, 4*C).

    ``kernel``/``bias`` are the plain ``subpixel`` head's (3, 3, Cin, C)
    HWIO kernel and (C,) bias; H and W must be even.  The bias is added
    after the conv, in the compute dtype (tiled in block order g), as
    the reference does — never inside ``conv2d``."""
    b, h, w, _ = feats.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d head needs even dims, got {h}x{w}")
    k4 = pack_s2d_kernel(kernel).to(compute_dtype).permute(3, 2, 0, 1)
    # the NHWC tensor viewed as NCHW is channels_last: zero-copy
    x = feats.to(compute_dtype).permute(0, 3, 1, 2)
    out = F.conv2d(x, k4.contiguous(memory_format=torch.channels_last),
                   None, stride=2, padding=1)
    # cuDNN keeps the channels_last layout, so the NHWC result is already
    # contiguous and .contiguous() is a no-op that only guards the tail
    return (out.permute(0, 2, 3, 1)
            + bias.repeat(4).to(compute_dtype)).contiguous()


def s2d_head_kernel_plain(feats: torch.Tensor, k4: torch.Tensor,
                          bias4: torch.Tensor,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of :func:`s2d_head_kernel`: (B, H, W, Cin)
    -> (B, H/2, W/2, Cout) with the packed (4, 4, Cin, Cout) ``k4`` and
    (Cout,) ``bias4``.

    The 16 taps are summed in float64, where every bf16 product and the
    whole sum are exact to far below an f32 ulp; the bias is added as an
    f32 value; the result is rounded once to ``out_dtype``.  The kernel
    sums in f32 in the tensor cores' order, so the two agree to within
    one ulp of the output (byte-exact on most values).  One frame at a
    time, so the float64 copies stay at one frame's size."""
    b, h, w, _ = feats.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d head needs even dims, got {h}x{w}")
    k = k4.double()
    bias = bias4.float().double()
    out = torch.empty((b, h // 2, w // 2, k4.shape[-1]), dtype=out_dtype,
                      device=feats.device)
    for i in range(b):
        # SAME padding: one zero row/column top/left; the bottom/right
        # zero keeps the last tap's stride-2 slice in range
        x = F.pad(feats[i].double(), (0, 0, 1, 1, 1, 1))
        acc = None
        for u in range(4):
            for v in range(4):
                term = x[u:u + h:2, v:v + w:2] @ k[u, v]
                acc = term if acc is None else acc + term
        out[i] = (acc + bias).float().to(out_dtype)
    return out


def repack_k4(k4: torch.Tensor) -> torch.Tensor:
    """(4, 4, Cin, Cout) packed kernel -> (16, Cout, Cin): tap ``u*4+v``,
    then output channel, then input channel (contiguous), the layout the
    head kernel reads.  A 32-channel slice of 4 taps is one TMA box whose
    rows are K-major for ``wgmma``'s B operand.  Pure indexing:
    ``repack_k4(k4)[u*4+v, n, c] == k4[u, v, c, n]``."""
    kh, kw, cin, cout = k4.shape
    return k4.reshape(kh * kw, cin, cout).transpose(1, 2).contiguous()


def s2d_head_kernel(feats: torch.Tensor, k4: torch.Tensor, bias4: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """The packed s2d head as one hand-written kernel, the counterpart of
    the spike's ``pallas_s2d_head(feats, k4, bias4, out_dtype)``.

    ``feats`` (B, H, W, 128) bf16 NHWC with H and W even, ``k4`` (4, 4,
    128, 48) bf16 (:func:`pack_s2d_kernel` of the ``subpixel`` kernel),
    ``bias4`` (48,) bf16 (the bias tiled 4 times) -> (B, H/2, W/2, 48) in
    ``out_dtype`` (bf16 or f32).

    A CUDA tensor launches ``csrc/s2d_head.cu`` on its device's current
    stream and raises on any other dtype, shape, layout or device (the
    three operands on more than one device too) — it never gives way to
    cuDNN; ``s2d_head_kernel.launches`` counts its launches.  A
    CPU tensor takes :func:`s2d_head_kernel_plain`.

    The kernel: persistent blocks, a TMA producer warp and two ``wgmma``
    consumer warpgroups over 8x32 output tiles; the input window comes in
    32-channel chunks by TMA (its zero fill is the SAME padding), the
    weights in 12 KB steps, both through rings of mbarrier-guarded
    slots; A reaches the tensor cores from registers (``ldmatrix`` over
    the window), B from shared memory.  Its bound is the bytes: at (8,
    1080, 1920, 128) 4.65 GB, 1.39 ms at an H100 SXM's 3.35 TB/s (PERF.md
    has its time).  Every call repacks ``k4`` with :func:`repack_k4` (one
    196 KB copy, inside the times PERF.md gives); a caller that ran the
    kernel on fixed weights would repack them once instead."""
    if feats.device.type == "cpu":
        return s2d_head_kernel_plain(feats, k4, bias4, out_dtype)
    if feats.device.type != "cuda":
        raise ValueError(f"s2d_head_kernel: unsupported device {feats.device}")
    kernels.same_device("s2d head kernel", feats=feats, k4=k4, bias4=bias4)
    for name, t in (("feats", feats), ("k4", k4), ("bias4", bias4)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"s2d head kernel takes bfloat16 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"s2d head kernel needs a contiguous {name}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"s2d head kernel writes bfloat16 or float32, got {out_dtype}")
    if (feats.ndim != 4 or feats.shape[-1] != _CIN
            or tuple(k4.shape) != (4, 4, _CIN, _COUT)
            or tuple(bias4.shape) != (_COUT,)):
        raise ValueError(
            f"s2d head kernel takes feats (B, H, W, {_CIN}), k4 (4, 4, {_CIN}, "
            f"{_COUT}) and bias4 ({_COUT},); got {tuple(feats.shape)}, "
            f"{tuple(k4.shape)}, {tuple(bias4.shape)}")
    b, h, w, _ = feats.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d head kernel needs even dims, got {h}x{w}")
    if feats.data_ptr() % 16:
        raise ValueError("s2d head kernel needs a 16-byte aligned feats")
    out = torch.empty((b, h // 2, w // 2, _COUT), dtype=out_dtype,
                      device=feats.device)
    if out.numel():
        w16 = repack_k4(k4)
        kernels.launch(kernels.function("s2d_head"), "s2d_head", feats.device,
                       feats.data_ptr(), w16.data_ptr(), bias4.data_ptr(),
                       out.data_ptr(), b, h, w, int(out_dtype == torch.float32))
        kernels.count_launch(s2d_head_kernel)
    return out


s2d_head_kernel.launches = 0
