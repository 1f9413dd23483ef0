"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU (the kernels have no CPU
mode) and skips without one; this file imports no JAX, so it runs on a
machine that has only PyTorch:

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
@pytest.mark.parametrize("wide", [False, True])
def test_s2d_tail_kernel_matches_plain(cuda_device, wide):
    rng = np.random.default_rng(13)
    shape = (2, 10, 12, 48)
    if wide:
        x = rng.uniform(-1.5, 1.5, shape) * 2.0 ** rng.integers(-20, 3, shape)
    else:
        x = rng.standard_normal(shape) * 0.6 + 0.3
    packed = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    before = tcs.fused_subpixel_ycc_s2d.launches
    got = tcs.fused_subpixel_ycc_s2d(packed.to(cuda_device), 2)
    torch.cuda.synchronize()
    assert tcs.fused_subpixel_ycc_s2d.launches == before + 1
    for g, w in zip(got, tcs.fused_subpixel_ycc_s2d_plain(packed, 2)):
        assert torch.equal(g.cpu(), w)
