"""SwinIR (Liang et al., "SwinIR: Image Restoration Using Swin
Transformer", arXiv:2108.10257) for real-world x4 super-resolution: the
published SwinIR-M x4 GAN model (github.com/JingyunLiang/SwinIR,
``models/network_swinir.py``; ``main_test_swinir.py`` task ``real_sr``:
embed 180, six RSTBs of six blocks, six heads, window 8, mlp ratio 2,
``nearest+conv`` upsampler, ``1conv`` residual connection).

Interface: (B, H, W, 3) NHWC RGB in [0, 1] -> (B, 4H, 4W, 3), the
contract of the engine's generic tail.  H and W are padded up to
multiples of the window with reflection at the bottom and right, and the
output is cropped back to (4H, 4W).  The model has no finite receptive
field (a shifted window hands information on by four pixels each block),
so :attr:`SwinIR.halo` is None and the engine never tiles it.

Parameter names are the official ones, so an official state dict loads
(:meth:`SwinIR.load_state_dict` checks the recomputed
``relative_position_index`` buffers against its own and drops the
``attn_mask`` buffers, which the official model builds for its training
size).  Tokens stay NHWC, (B, Hp, Wp, C): the official (B, L, C) is the
same memory.

Precision: activations in the compute dtype.  Linears and convs take the
bias as ``nn.Linear``/``nn.Conv2d`` do (inside the matmul's epilogue);
LayerNorm, GELU and the softmax accumulate in f32, as PyTorch's kernels
do for bf16.  The input normalisation and the final ``/ img_range +
mean`` run in f32.

Window attention is ``F.scaled_dot_product_attention`` with one additive
mask per block: the learned relative-position bias, plus the shift mask
on shifted blocks.  The head dimension (30 at the published widths) is
zero-padded to a multiple of 8 inside the qkv and proj weights, so the
fused backends take the call; zero columns add nothing to q.k or to the
output, and the scale stays ``head_dim ** -0.5``.  The shifted blocks'
region mask, which depends on the padded frame size alone, is built once
per size and cached on the module (:meth:`SwinIR.regions`); each block
adds its bias to it in its forward, into one contiguous mask in the
compute dtype.  While the engine times a batch, each block's attention
(mask add included) is bracketed with CUDA events (:attr:`SwinIR.spans`,
the hop ``attention``), and so is a new size's region build (``mask``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ..parallel.transfer import DeviceSpans

# the official x4 real-world model's settings (main_test_swinir.py, real_sr)
RGB_MEAN = (0.4488, 0.4371, 0.4040)
# CUDA grids allow 65535 blocks in y and z: attention calls take at most
# this many windows
MAX_WINDOWS_PER_CALL = 32768
SHIFT_MASK = -100.0   # the official mask value between regions


@dataclasses.dataclass(frozen=True)
class SwinIRConfig:
    scale: int = 4
    in_chans: int = 3
    embed_dim: int = 180
    depths: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    num_heads: Tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    window_size: int = 8
    mlp_ratio: float = 2.0
    num_feat: int = 64
    upsampler: str = "nearest+conv"
    img_range: float = 1.0
    rgb_mean: Tuple[float, ...] = RGB_MEAN
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.upsampler != "nearest+conv" or self.scale != 4:
            raise ValueError("SwinIR runs the nearest+conv upsampler at scale 4 "
                             f"only, not {self.upsampler!r} at {self.scale}")
        if len(self.depths) != len(self.num_heads):
            raise ValueError("depths and num_heads name one entry per RSTB")
        for heads in self.num_heads:
            if self.embed_dim % heads:
                raise ValueError(f"embed_dim {self.embed_dim} is not a multiple "
                                 f"of {heads} heads")


def relative_position_index(window: int) -> torch.Tensor:
    """(N, N) index into the (2w-1)^2-row bias table, N = w*w: the
    official ``relative_position_index``."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def shift_mask(height: int, width: int, window: int, shift: int,
               device=None) -> torch.Tensor:
    """(nW, N, N) f32 mask of a shifted block on a (height, width) map: 0
    between tokens of one of the nine regions of the rolled map, -100
    between regions (the official ``calculate_mask``)."""
    regions = torch.zeros((1, height, width, 1), device=device)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for i, (hs, ws) in enumerate((h, w) for h in cuts for w in cuts):
        regions[:, hs, ws, :] = i
    ids = window_partition(regions, window).squeeze(-1)
    diff = ids[:, None, :] - ids[:, :, None]
    return torch.where(diff != 0, SHIFT_MASK, 0.0)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, window * window, C), windows row-major."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(windows: torch.Tensor, window: int, height: int,
                   width: int) -> torch.Tensor:
    """(B * nW, window * window, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    x = windows.view(-1, height // window, width // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, height, width, c)


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, norm.normalized_shape, norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``x``: NCHW (channels_last) in the compute dtype."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=1)


def _chunks(total: int, period: int, limit: int) -> Iterator[Tuple[int, int]]:
    """(start, stop) ranges of at most ``limit`` that never cross a
    multiple of ``period``."""
    for first in range(0, total, period):
        end = min(first + period, total)
        for i in range(first, end, limit):
            yield i, min(i + limit, end)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside windows, with the learned
    relative-position bias (module docstring)."""

    def __init__(self, dim: int, window: int, heads: int, dtype: torch.dtype,
                 spans: DeviceSpans):
        super().__init__()
        self.heads = heads
        self.head_dim = dim // heads
        self.padded_dim = -(-self.head_dim // 8) * 8
        self.window = window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads, dtype=dtype))
        self.qkv = skip_init(nn.Linear, dim, 3 * dim, dtype=dtype)
        self.proj = skip_init(nn.Linear, dim, dim, dtype=dtype)
        self.register_buffer("relative_position_index",
                             relative_position_index(window), persistent=False)
        self._spans = spans

    def bias(self) -> torch.Tensor:
        """(heads, N, N) f32 relative-position bias."""
        n = self.window * self.window
        table = self.relative_position_bias_table.float()
        return table[self.relative_position_index.view(-1)].view(n, n, -1).permute(2, 0, 1)

    def _padded(self, dtype: torch.dtype):
        """qkv weight and bias, proj weight: the head dimension zero-padded
        to ``padded_dim`` (rows of qkv, columns of proj)."""
        h, d, p = self.heads, self.head_dim, self.padded_dim
        w_qkv, b_qkv = self.qkv.weight.to(dtype), self.qkv.bias.to(dtype)
        w_proj = self.proj.weight.to(dtype)
        if p == d:
            return w_qkv, b_qkv, w_proj
        dim = w_qkv.shape[1]
        wq = w_qkv.new_zeros(3, h, p, dim)
        wq[:, :, :d] = w_qkv.view(3, h, d, dim)
        bq = b_qkv.new_zeros(3, h, p)
        bq[:, :, :d] = b_qkv.view(3, h, d)
        wp = w_proj.new_zeros(dim, h, p)
        wp[:, :, :d] = w_proj.view(dim, h, d)
        return wq.view(3 * h * p, dim), bq.view(-1), wp.view(dim, h * p)

    def mask(self, regions: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
        """The block's additive mask in ``dtype``: (1, heads, N, N), the
        bias, or with ``regions`` ((nW, 1, N, N), a shifted block's)
        (nW, heads, N, N).  Contiguous: the fused attention kernels read
        masks with unit stride in their last dim, and the bias gathers
        out permuted."""
        bias = self.bias().to(dtype, memory_format=torch.contiguous_format)[None]
        return bias if regions is None else regions + bias

    def forward(self, windows: torch.Tensor,
                regions: Optional[torch.Tensor]) -> torch.Tensor:
        """``windows``: (B * nW, N, C); ``regions``: the (nW, 1, N, N) region
        mask of a shifted block's frame (:meth:`SwinIR.regions`), or None."""
        count, n, _ = windows.shape
        h, p = self.heads, self.padded_dim
        w_qkv, b_qkv, w_proj = self._padded(windows.dtype)
        q, k, v = F.linear(windows, w_qkv, b_qkv).view(count, n, 3, h, p).permute(
            2, 0, 3, 1, 4).unbind(0)
        # q, k, v and the output; the mask read once a frame, and a
        # shifted block's mask written from its regions
        nbytes = 4 * q.numel()
        if regions is not None:
            size = regions.shape[0] * h * n * n
            nbytes += size * (count // regions.shape[0] + 1) + regions.numel()
        else:
            nbytes += h * n * n
        outs = []
        with self._spans.span("attention", nbytes * q.element_size(), windows.device):
            mask = self.mask(regions, windows.dtype)
            per_window = mask.shape[0] > 1
            period = mask.shape[0] if per_window else count
            for i, j in _chunks(count, period, MAX_WINDOWS_PER_CALL):
                m = (mask[i % period:i % period + j - i] if per_window
                     else mask.expand(j - i, -1, -1, -1))
                outs.append(F.scaled_dot_product_attention(
                    q[i:j], k[i:j], v[i:j], attn_mask=m, scale=self.head_dim ** -0.5))
        out = torch.cat(outs) if len(outs) > 1 else outs[0]
        out = out.transpose(1, 2).reshape(count, n, h * p)
        return F.linear(out, w_proj, self.proj.bias.to(windows.dtype))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = skip_init(nn.Linear, dim, hidden, dtype=dtype)
        self.fc2 = skip_init(nn.Linear, hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(F.gelu(_linear(x, self.fc1)), self.fc2)


class SwinTransformerBlock(nn.Module):
    """``x + WA(norm1(x))``, then ``x + mlp(norm2(x))``; odd blocks roll
    the map by half a window around the attention."""

    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: float, dtype: torch.dtype, spans: DeviceSpans):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, dtype=dtype)
        self.attn = WindowAttention(dim, window, heads, dtype, spans)
        self.norm2 = nn.LayerNorm(dim, dtype=dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor, regions: torch.Tensor) -> torch.Tensor:
        """``x``: (B, Hp, Wp, C) tokens; ``regions``: the frame's region
        mask, which only a shifted block reads."""
        _, height, width, _ = x.shape
        h = _layer_norm(x, self.norm1)
        if self.shift:
            h = torch.roll(h, (-self.shift, -self.shift), (1, 2))
        h = window_reverse(self.attn(window_partition(h, self.window),
                                     regions if self.shift else None),
                           self.window, height, width)
        if self.shift:
            h = torch.roll(h, (self.shift, self.shift), (1, 2))
        x = x + h
        return x + self.mlp(_layer_norm(x, self.norm2))


class BasicLayer(nn.Module):
    def __init__(self, blocks: List[SwinTransformerBlock]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """Residual Swin Transformer Block: the blocks, a 3x3 conv, and the
    block's input added back."""

    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 mlp_ratio: float, dtype: torch.dtype, spans: DeviceSpans):
        super().__init__()
        self.residual_group = BasicLayer([
            SwinTransformerBlock(dim, heads, window, 0 if j % 2 == 0 else window // 2,
                                 mlp_ratio, dtype, spans)
            for j in range(depth)])
        self.conv = skip_init(nn.Conv2d, dim, dim, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor, regions: torch.Tensor) -> torch.Tensor:
        h = x
        for block in self.residual_group.blocks:
            h = block(h, regions)
        return _conv(h.permute(0, 3, 1, 2), self.conv).permute(0, 2, 3, 1) + x


class SwinIR(nn.Module):
    """(B, H, W, 3) RGB in [0, 1] -> (B, 4H, 4W, 3) (module docstring).

    Seeded init draws from an explicit ``torch.Generator`` with the
    official distributions: linears and bias tables truncated normal of
    std 0.02 with zero biases, LayerNorm (1, 0), convs PyTorch's default
    (uniform within 1/sqrt(fan_in), biases too)."""

    halo = None  # no finite receptive field: never tiled

    def __init__(self, config: SwinIRConfig = SwinIRConfig(), seed: Optional[int] = 0):
        super().__init__()
        self.config = cfg = config
        dim, dt, feat = cfg.embed_dim, cfg.param_dtype, cfg.num_feat
        self.spans = DeviceSpans()
        self.register_buffer("mean", torch.tensor(cfg.rgb_mean).view(1, -1, 1, 1),
                             persistent=False)
        self.conv_first = skip_init(nn.Conv2d, cfg.in_chans, dim, 3, padding=1, dtype=dt)
        self.patch_embed = nn.Module()
        self.patch_embed.norm = nn.LayerNorm(dim, dtype=dt)
        self.layers = nn.ModuleList(
            RSTB(dim, depth, heads, cfg.window_size, cfg.mlp_ratio, dt, self.spans)
            for depth, heads in zip(cfg.depths, cfg.num_heads))
        self.norm = nn.LayerNorm(dim, dtype=dt)
        self.conv_after_body = skip_init(nn.Conv2d, dim, dim, 3, padding=1, dtype=dt)
        self.conv_before_upsample = nn.Sequential(
            skip_init(nn.Conv2d, dim, feat, 3, padding=1, dtype=dt), nn.LeakyReLU())
        self.conv_up1 = skip_init(nn.Conv2d, feat, feat, 3, padding=1, dtype=dt)
        self.conv_up2 = skip_init(nn.Conv2d, feat, feat, 3, padding=1, dtype=dt)
        self.conv_hr = skip_init(nn.Conv2d, feat, feat, 3, padding=1, dtype=dt)
        self.conv_last = skip_init(nn.Conv2d, feat, cfg.in_chans, 3, padding=1, dtype=dt)
        # (height, width, device) of a padded size -> its region mask;
        # the latest size only
        self._regions: Dict[tuple, torch.Tensor] = {}
        self.reset_parameters(torch.Generator().manual_seed(0 if seed is None else seed))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, nn.Linear):
                    nn.init.trunc_normal_(module.weight, 0.0, 0.02, -2.0, 2.0,
                                          generator=generator)
                    module.bias.zero_()
                elif isinstance(module, nn.Conv2d):
                    bound = 1.0 / math.sqrt(module.weight[0].numel())
                    module.weight.uniform_(-bound, bound, generator=generator)
                    module.bias.uniform_(-bound, bound, generator=generator)
                elif isinstance(module, nn.LayerNorm):
                    module.weight.fill_(1.0)
                    module.bias.zero_()
                elif isinstance(module, WindowAttention):
                    nn.init.trunc_normal_(module.relative_position_bias_table, 0.0, 0.02,
                                          -2.0, 2.0, generator=generator)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """An official state dict (or one wrapped under ``params_ema`` or
        ``params``, as the published files are), or this module's own."""
        for wrapper in ("params_ema", "params"):
            if wrapper in state_dict:
                state_dict = state_dict[wrapper]
                break
        state = dict(state_dict)
        for key in list(state):
            if key.endswith(".attn_mask"):
                del state[key]  # built for the official training size
            elif key.endswith(".relative_position_index"):
                own = self.get_submodule(key.rsplit(".", 1)[0]).relative_position_index
                if not torch.equal(state.pop(key).to(own.device), own):
                    raise ValueError(f"{key} differs from the index this window "
                                     "size gives")
        return super().load_state_dict(state, strict=strict, assign=assign)

    # ------------------------------------------------------------------
    def padded_size(self, height: int, width: int) -> Tuple[int, int]:
        w = self.config.window_size
        return height + (-height) % w, width + (-width) % w

    def regions(self, height: int, width: int) -> torch.Tensor:
        """The (nW, 1, N, N) shift mask of (height, width) padded frames,
        in the compute dtype, built once per padded size (the latest size
        only; billed as the span ``mask``)."""
        cfg = self.config
        device = self.conv_first.weight.device
        key = (height, width, device)
        if key not in self._regions:
            n = cfg.window_size ** 2
            nbytes = height * width * n * cfg.compute_dtype.itemsize
            with self.spans.span("mask", nbytes, device):
                mask = shift_mask(height, width, cfg.window_size, cfg.window_size // 2,
                                  device)
                self._regions = {key: mask.to(cfg.compute_dtype)[:, None]}
        return self._regions[key]

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt = cfg.compute_dtype
        _, height, width, _ = frames.shape
        hp, wp = self.padded_size(height, width)
        regions = self.regions(hp, wp)
        x = frames.float().permute(0, 3, 1, 2)
        if (hp, wp) != (height, width):
            x = F.pad(x, (0, wp - width, 0, hp - height), mode="reflect")
        x = ((x - self.mean) * cfg.img_range).to(dt).contiguous(
            memory_format=torch.channels_last)
        first = _conv(x, self.conv_first)
        h = _layer_norm(first.permute(0, 2, 3, 1), self.patch_embed.norm)
        for layer in self.layers:
            h = layer(h, regions)
        h = _layer_norm(h, self.norm).permute(0, 3, 1, 2)
        x = _conv(h, self.conv_after_body) + first
        x = F.leaky_relu(_conv(x, self.conv_before_upsample[0]), 0.01)
        for conv in (self.conv_up1, self.conv_up2):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = F.leaky_relu(_conv(x, conv), 0.2)
        x = _conv(F.leaky_relu(_conv(x, self.conv_hr), 0.2), self.conv_last)
        out = x.permute(0, 2, 3, 1)[:, :height * cfg.scale, :width * cfg.scale]
        return out.float() / cfg.img_range + self.mean.view(1, 1, 1, -1)
