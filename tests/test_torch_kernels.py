"""The port's CUDA kernels against their plain PyTorch versions, and the
train step against the CPU's, on the card.  Every test here needs an
NVIDIA GPU (the kernels have no CPU mode) and skips without one; this
file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from downloader_tpu_torch.compute.ops import colorspace as tcs
from downloader_tpu_torch.compute.ops import pixel_shuffle as tps


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _quantize_inputs(seed: int) -> torch.Tensor:
    """Out-of-range values and exact .5 ties in a ragged shape."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-40, 300, (3, 5, 7, 13)).astype(np.float32)
    ties = rng.integers(-3, 258, x.shape) + 0.5
    mask = rng.random(x.shape) < 0.3
    x[mask] = ties[mask]
    return torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])  # 1: unaligned -> scalar path
def test_quantize_u8_kernel_matches_plain(cuda_device, dtype, offset):
    x = _quantize_inputs(12).to(dtype).view(-1)[offset:]
    before = tps.quantize_u8.launches
    got = tps.quantize_u8(x.to(cuda_device)).cpu()
    torch.cuda.synchronize()
    assert tps.quantize_u8.launches == before + 1
    assert torch.equal(got, tps.quantize_u8_plain(x))


@pytest.mark.cuda
def test_quantize_u8_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((4, 4), device=cuda_device)
    with pytest.raises(ValueError):
        tps.quantize_u8(x.t())
    with pytest.raises(TypeError):
        tps.quantize_u8(x.double())


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1, 2, 3, 4, 5])  # 5: the run-time-scale loop
@pytest.mark.parametrize("wide", [False, True])
def test_s2d_tail_kernel_matches_plain(cuda_device, wide, scale):
    rng = np.random.default_rng(13)
    shape = (2, 10, 12, 12 * scale * scale)
    if wide:
        x = rng.uniform(-1.5, 1.5, shape) * 2.0 ** rng.integers(-20, 3, shape)
    else:
        x = rng.standard_normal(shape) * 0.6 + 0.3
    packed = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    before = tcs.fused_subpixel_ycc_s2d.launches
    got = tcs.fused_subpixel_ycc_s2d(packed.to(cuda_device), scale)
    torch.cuda.synchronize()
    assert tcs.fused_subpixel_ycc_s2d.launches == before + 1
    for g, w in zip(got, tcs.fused_subpixel_ycc_s2d_plain(packed, scale)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_s2d_tail_kernel_rejects_what_it_does_not_take(cuda_device):
    packed = torch.zeros((1, 4, 6, 48), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        tcs.fused_subpixel_ycc_s2d(packed, 3)                 # 48 channels at scale 3
    with pytest.raises(TypeError):
        tcs.fused_subpixel_ycc_s2d(packed.float(), 2)
    with pytest.raises(ValueError):
        tcs.fused_subpixel_ycc_s2d(packed.transpose(1, 2), 2)


def _head_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    feats = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    k4 = torch.from_numpy(rng.standard_normal((4, 4, 128, 48)).astype(np.float32)
                          / np.sqrt(1152))
    bias4 = torch.from_numpy(rng.standard_normal(48).astype(np.float32) * 0.1)
    return (feats.to(torch.bfloat16), k4.to(torch.bfloat16),
            bias4.to(torch.bfloat16))


def _head_ulps(got, want):
    """|got - want| in bf16 ulps of |want|, with magnitudes under 1/256
    of the output's RMS counted at that floor: there, where the ~2048
    terms of a sum cancel, the f32 sum's own rounding error is more than
    a bf16 ulp of the result."""
    g, w = got.float(), want.float()
    floor = w.pow(2).mean().sqrt() / 256
    _, exp = torch.frexp(torch.maximum(w.abs(), floor))
    return (g - w).abs() / torch.ldexp(torch.ones_like(w), exp - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out_dtype", [
    ((2, 64, 256, 128), torch.bfloat16),   # the spike's check shape
    ((1, 18, 34, 128), torch.bfloat16),    # ragged: H/2 = 9, W/2 = 17
    ((1, 18, 34, 128), torch.float32),
    ((3, 2, 2, 128), torch.bfloat16),      # one output pixel, all edges
    ((2, 34, 200, 128), torch.bfloat16),   # ragged tiles at the right edge
])
def test_s2d_head_kernel_matches_plain(cuda_device, shape, out_dtype):
    """Within one bf16 ulp (see :func:`_head_ulps`), >= 99% exact: the
    tensor cores sum in f32 in their own order, the plain version in
    float64, and a sum next to a rounding boundary can tip either way."""
    from downloader_tpu_torch.compute.ops import s2d_head as thead

    feats, k4, bias4 = _head_inputs(shape, 14)
    before = thead.s2d_head_kernel.launches
    got = thead.s2d_head_kernel(feats.to(cuda_device), k4.to(cuda_device),
                                bias4.to(cuda_device), out_dtype).cpu()
    torch.cuda.synchronize()
    assert thead.s2d_head_kernel.launches == before + 1
    want = thead.s2d_head_kernel_plain(feats, k4, bias4, out_dtype)
    assert got.shape == want.shape and got.dtype == out_dtype
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return
    assert float(_head_ulps(got, want).max()) <= 1
    assert float((got == want).double().mean()) >= 0.99


@pytest.mark.cuda
def test_s2d_head_kernel_rejects_what_it_does_not_take(cuda_device):
    from downloader_tpu_torch.compute.ops import s2d_head as thead

    feats, k4, bias4 = (t.to(cuda_device) for t in _head_inputs((1, 4, 6, 128), 15))
    with pytest.raises(TypeError):
        thead.s2d_head_kernel(feats.float(), k4, bias4)
    with pytest.raises(ValueError):
        thead.s2d_head_kernel(feats[:, :3], k4, bias4)       # odd height
    with pytest.raises(ValueError):
        thead.s2d_head_kernel(feats[..., :64].contiguous(), k4[:, :, :64], bias4)
    with pytest.raises(ValueError):
        thead.s2d_head_kernel(feats.transpose(1, 2), k4, bias4)
    with pytest.raises(ValueError):
        thead.s2d_head_kernel(feats, k4.cpu(), bias4)
    with pytest.raises(TypeError):
        thead.s2d_head_kernel(feats, k4, bias4, torch.float16)


@pytest.mark.cuda
def test_engine_paths_launch_the_quantize_kernel(cuda_device):
    """The generic tail (4:4:4 at scale 2) quantizes its three planes with
    the standalone kernel; the s2d branch at scale 1 (4:4:4, even dims)
    launches the tail kernel once."""
    from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler

    config = UpscalerConfig(features=8, depth=2)
    engine = FrameUpscaler(config, batch=2)
    planes = [np.random.default_rng(16).integers(0, 256, (2, 12, 16), np.uint8)
              for _ in range(3)]
    before = tps.quantize_u8.launches
    out = engine.upscale_batch(*planes, 1, 1)
    assert tps.quantize_u8.launches == before + 3
    assert [p.shape for p in out] == [(2, 24, 32)] * 3
    cpu = FrameUpscaler(config, batch=2, device="cpu")
    cpu.model.load_state_dict(engine.model.state_dict())
    for g, w in zip(out, cpu.upscale_batch(*planes, 1, 1)):
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
    config1 = UpscalerConfig(features=8, depth=2, scale=1)
    scale1 = FrameUpscaler(config1, batch=2)
    before = (tps.quantize_u8.launches, tcs.fused_subpixel_ycc_s2d.launches)
    out = scale1.upscale_batch(*planes, 1, 1)
    assert (tps.quantize_u8.launches, tcs.fused_subpixel_ycc_s2d.launches) == (
        before[0], before[1] + 1)
    cpu1 = FrameUpscaler(config1, batch=2, device="cpu")
    cpu1.model.load_state_dict(scale1.model.state_dict())
    for g, w in zip(out, cpu1.upscale_batch(*planes, 1, 1)):
        assert g.shape == (2, 12, 16)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pixel_shuffle_clip_u8_launches_the_quantize_kernel_once(cuda_device, dtype):
    x = torch.from_numpy(np.random.default_rng(17).uniform(
        -40, 300, (2, 6, 10, 12)).astype(np.float32)).to(dtype)
    before = tps.quantize_u8.launches
    got = tps.pixel_shuffle_clip_u8(x.to(cuda_device), 2).cpu()
    torch.cuda.synchronize()
    assert tps.quantize_u8.launches == before + 1
    assert torch.equal(got, tps.pixel_shuffle_clip_u8(x, 2))


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu_and_checkpoints_cross(
        cuda_device, tmp_path):
    """One seeded init and batch, two steps on each device: losses within
    1e-3 and 1e-2 relative (bf16 sums in cuDNN's order; the second after
    one Adam step), no kernel of the port launched; the card's checkpoint
    restores on the CPU as the same state and steps on there, and resumes
    on the card."""
    from downloader_tpu_torch.compute import checkpoint
    from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
    from downloader_tpu_torch.compute.ops.s2d_head import s2d_head_kernel
    from downloader_tpu_torch.compute.train import make_train_step

    config = UpscalerConfig(features=32, depth=3)
    card_step, card_init = make_train_step(config, device=cuda_device)
    cpu_step, cpu_init = make_train_step(config, device="cpu")
    rng = np.random.default_rng(18)
    low = torch.from_numpy(rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32))
    high = low.repeat_interleave(2, 1).repeat_interleave(2, 2)
    wrappers = (tps.quantize_u8, tcs.fused_subpixel_ycc_s2d, s2d_head_kernel)
    before = [w.launches for w in wrappers]
    card, cpu = card_init(3), cpu_init(3)
    got = [float(card_step(card, low.to(cuda_device), high.to(cuda_device)))
           for _ in range(2)]
    want = [float(cpu_step(cpu, low, high)) for _ in range(2)]
    assert [w.launches for w in wrappers] == before
    assert abs(got[0] - want[0]) <= 1e-3 * want[0]
    assert abs(got[1] - want[1]) <= 1e-2 * want[1]

    checkpoint.save_state(tmp_path / "card", 2, card.model.state_dict(),
                          card.optimizer.state_dict())
    for init, step, device in ((cpu_init, cpu_step, "cpu"),
                               (card_init, card_step, cuda_device)):
        state = init(9)
        _, params, opt_state = checkpoint.restore_state(
            tmp_path / "card", state.model.state_dict())
        state.model.load_state_dict(params)
        checkpoint.load_optimizer_state(state.optimizer, opt_state)
        for name, value in card.model.state_dict().items():
            assert torch.equal(state.model.state_dict()[name].cpu(), value.cpu())
        assert np.isfinite(float(step(state, low.to(device), high.to(device))))
        assert float(state.optimizer.state_dict()["state"][0]["step"]) == 3.0


_EPILOGUE_VARIANTS = {"bias": (False, False), "relu": (True, False),
                      "residual": (True, True)}


def _epilogue_operand(shape, seed, device):
    """A (B, H, W, C) bf16 tensor made on the card, viewed as (B, C, H,
    W) channels_last: normal values with ~5% -0, ~5% +0 and ~2% NaN."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, dtype=torch.bfloat16, generator=gen, device=device)
    pick = torch.randint(0, 100, shape, dtype=torch.uint8, generator=gen, device=device)
    x.masked_fill_(pick < 5, -0.0)
    x.masked_fill_((pick >= 5) & (pick < 10), 0.0)
    x.masked_fill_((pick >= 10) & (pick < 12), float("nan"))
    return x.permute(0, 3, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (8, 1080, 1920, 128),   # a 1080p batch's body conv
    (8, 540, 960, 128),     # a 540p batch's body conv
    (8, 540, 960, 48),      # the x4 sub-pixel head: 6 groups of 8 a pixel
    (3, 37, 53, 12),        # the x2 head on odd dims: the scalar variant
])
@pytest.mark.parametrize("variant", sorted(_EPILOGUE_VARIANTS))
def test_conv_epilogue_kernel_matches_plain(cuda_device, variant, shape):
    """Bit for bit the plain three ops on the card, +-0 and NaN included
    (in the bias too), written in place over the conv output."""
    from downloader_tpu_torch.compute.ops import conv_epilogue as tep

    relu, residual = _EPILOGUE_VARIANTS[variant]
    y = _epilogue_operand(shape, 20, cuda_device)
    x = _epilogue_operand(shape, 21, cuda_device) if residual else None
    b = _epilogue_operand((1, 1, 1, shape[-1]), 22, cuda_device).reshape(-1)
    b[:3] = torch.tensor([-0.0, 0.0, float("nan")], dtype=torch.bfloat16)
    want = tep.conv_epilogue_plain(y, b, relu, x)
    out = y.clone()
    before = tep.conv_epilogue.launches
    got = tep.conv_epilogue(out, b, relu, x)
    torch.cuda.synchronize()
    assert tep.conv_epilogue.launches == before + 1
    assert got.data_ptr() == out.data_ptr() and got.shape == y.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_conv_epilogue_kernel_rejects_what_it_does_not_take(cuda_device):
    from downloader_tpu_torch.compute.ops import conv_epilogue as tep

    y = torch.zeros((2, 16, 4, 6), dtype=torch.bfloat16,
                    device=cuda_device).contiguous(memory_format=torch.channels_last)
    b = torch.zeros(16, dtype=torch.bfloat16, device=cuda_device)
    before = tep.conv_epilogue.launches
    for args in ((y.float(), b, True), (y, b.float(), True), (y, b, True, y.float())):
        with pytest.raises(TypeError):
            tep.conv_epilogue(*args)
    for args in ((y.contiguous(), b, True),          # NCHW, not channels_last
                 (y, b[:15], True),                  # a bias of another width
                 (y, b.cpu(), True),                 # on another device
                 (y, b, True, y[:1].clone()),        # a residual of another shape
                 (y, b, True, y)):                   # the residual is y
        with pytest.raises(ValueError):
            tep.conv_epilogue(*args)
    with pytest.raises(RuntimeError):                # autograd would lose the op
        tep.conv_epilogue(y, b.clone().requires_grad_(), True)
    # refused by the C entry, raised by kernels.check: a residual with no
    # relu, and more channel groups than a block holds (1025 channels,
    # not a multiple of 8, are 1025 groups of one)
    wide = torch.zeros((1, 1025, 1, 1), dtype=torch.bfloat16,
                       device=cuda_device).contiguous(memory_format=torch.channels_last)
    for args in ((y, b, False, y.clone()),
                 (wide, torch.zeros(1025, dtype=torch.bfloat16, device=cuda_device))):
        with pytest.raises(RuntimeError, match="conv_epilogue"):
            tep.conv_epilogue(*args)
    assert tep.conv_epilogue.launches == before


@pytest.mark.cuda
def test_each_path_launches_the_epilogue_once_per_conv(cuda_device):
    """Per ``_core``: 4 launches on the x2 4:2:0 path (stem and three body
    convs; the s2d head adds its own bias), 5 on the generic tail (x4) and
    on the odd-dims branch (the head too); none in a train step."""
    from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
    from downloader_tpu_torch.compute.ops.conv_epilogue import conv_epilogue
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler
    from downloader_tpu_torch.compute.train import make_train_step

    rng = np.random.default_rng(23)
    for scale, (h, w), sub, want in ((2, (16, 24), 2, 4),   # s2d head and tail
                                     (4, (16, 24), 2, 5),   # generic tail
                                     (1, (15, 23), 1, 5)):  # odd dims
        engine = FrameUpscaler(UpscalerConfig(scale=scale, features=16, depth=4),
                               batch=2)
        planes = [rng.integers(0, 256, (2, h, w), np.uint8)]
        planes += [rng.integers(0, 256, (2, h // sub, w // sub), np.uint8)
                   for _ in range(2)]
        before = conv_epilogue.launches
        engine.upscale_batch(*planes, sub, sub)
        torch.cuda.synchronize()
        assert conv_epilogue.launches - before == want, (scale, sub)
    step, init = make_train_step(UpscalerConfig(features=16, depth=4),
                                 device=cuda_device)
    low = torch.rand((2, 8, 8, 3), device=cuda_device)
    before = conv_epilogue.launches
    step(init(0), low, low.repeat_interleave(2, 1).repeat_interleave(2, 2))
    torch.cuda.synchronize()
    assert conv_epilogue.launches == before


def _y4m_clip(width, height, frames, seed) -> bytes:
    import io

    from downloader_tpu_torch.compute.video import Y4MHeader, Y4MWriter

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    hdr = Y4MHeader(width=width, height=height, colorspace="420jpeg")
    writer = Y4MWriter(buf, hdr)
    for _ in range(frames):
        writer.write_frame(rng.integers(0, 256, (height, width), np.uint8),
                           rng.integers(0, 256, hdr.chroma_shape, np.uint8),
                           rng.integers(0, 256, hdr.chroma_shape, np.uint8))
    return buf.getvalue()


@pytest.mark.cuda
@pytest.mark.parametrize("scale, width, height", [(2, 1920, 1080), (4, 960, 540)])
@pytest.mark.parametrize("listed", [1, 2])
def test_engine_stream_keeps_the_three_op_bytes(cuda_device, monkeypatch, scale,
                                                width, height, listed):
    """16 frames through ``upscale_to`` at full width, on ``cuda:0``
    listed once or twice: the epilogue kernel gives the stream the three
    PyTorch ops (the model before the kernel) give in its place."""
    import io

    from downloader_tpu_torch.compute.models import upscaler as tup
    from downloader_tpu_torch.compute.ops.conv_epilogue import (
        conv_epilogue,
        conv_epilogue_plain,
    )
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler

    config = tup.UpscalerConfig(scale=scale)
    params = tup.Upscaler(config, seed=scale).state_dict()
    gen = torch.Generator().manual_seed(scale)
    for name, value in params.items():
        if name.endswith("bias"):  # the seeded init's are zero
            value.normal_(0.0, 0.05, generator=gen)
    engine = FrameUpscaler(config, params=params, devices=["cuda:0"] * listed)
    clip = _y4m_clip(width, height, 16, seed=scale)
    fused, plain = io.BytesIO(), io.BytesIO()
    before = conv_epilogue.launches
    assert engine.upscale_to(io.BytesIO(clip), fused) == 16
    assert conv_epilogue.launches - before == 2 * listed * (4 if scale == 2 else 5)
    monkeypatch.setattr(tup, "conv_epilogue", conv_epilogue_plain)
    before = conv_epilogue.launches
    assert engine.upscale_to(io.BytesIO(clip), plain) == 16
    assert conv_epilogue.launches == before
    assert fused.getvalue() == plain.getvalue()
