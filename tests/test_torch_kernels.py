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
