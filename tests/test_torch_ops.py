"""The PyTorch port's ops held against the JAX package's, on the CPU.

Inputs come from numpy seeds and cross between the frameworks as numpy
arrays.  On the CPU each port op runs its plain PyTorch version; the
CUDA kernels are held against those same plain versions on the card by
``tests/test_torch_kernels.py`` (skipped without a GPU) and by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from downloader_tpu.compute.ops import colorspace as jcs
from downloader_tpu.compute.ops.pixel_shuffle import (
    _pallas_quantize_u8,
    _pallas_shuffle_clip,
    pixel_shuffle as jax_pixel_shuffle,
    pixel_shuffle_clip_u8 as jax_pixel_shuffle_clip_u8,
)
from downloader_tpu.compute.ops import s2d_head as jhead
from downloader_tpu_torch.compute.ops import colorspace as tcs
from downloader_tpu_torch.compute.ops import pixel_shuffle as tps
from downloader_tpu_torch.compute.ops import s2d_head as thead


def _bf16(x: np.ndarray):
    """The same bf16 values as a numpy (for JAX) and a torch array."""
    xb = np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)
    return xb, torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16)


def _quantize_inputs(seed: int) -> np.ndarray:
    """f32 values with out-of-range entries and exact .5 ties (even and
    odd integer parts, negative ones too) in a ragged shape."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-40, 300, (3, 5, 7, 16)).astype(np.float32)
    ties = rng.integers(-3, 258, x.shape) + 0.5
    mask = rng.random(x.shape) < 0.3
    x[mask] = ties[mask]
    x.flat[:6] = [0.5, 1.5, 2.5, 254.5, 255.5, -0.5]
    return x


def test_pixel_shuffle_matches_reference_channel_order():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4, 12)).astype(np.float32)
    want = np.asarray(jax_pixel_shuffle(jnp.asarray(x), 2))
    got = tps.pixel_shuffle(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)
    # torch's own pixel_shuffle orders channels c*r*r + di*r + dj: it
    # must NOT agree, or this test would not guard the channel order
    theirs = torch.nn.functional.pixel_shuffle(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert not np.array_equal(theirs.numpy(), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_u8_plain_matches_pallas_and_xla(dtype):
    x = _quantize_inputs(1)
    if dtype == "bf16":
        xj, xt = _bf16(x)
    else:
        xj, xt = x, torch.from_numpy(x)
    got = tps.quantize_u8_plain(xt).numpy()
    xla = np.asarray(jnp.clip(jnp.round(jnp.asarray(xj)), 0, 255)
                     .astype(jnp.uint8))
    # the Pallas kernel runs only when its (rows, cols) view has rows % 8
    # == 0 (3*5*7 rows would take its XLA branch): hold it on 104 rows
    rows = np.asarray(xj).reshape(-1, 16)[:104]
    pallas = np.asarray(_pallas_quantize_u8(jnp.asarray(rows),
                                                interpret=True))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got.reshape(-1, 16)[:104], pallas)
    # and the ties went to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 254.5 -> 254
    assert list(got.flat[:6]) == [0, 2, 2, 254, 255, 0]


def test_quantize_u8_dispatches_plain_on_cpu():
    x = torch.from_numpy(_quantize_inputs(2))
    before = tps.quantize_u8.launches
    np.testing.assert_array_equal(tps.quantize_u8(x).numpy(),
                                  tps.quantize_u8_plain(x).numpy())
    assert tps.quantize_u8.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scale", [1, 2, 3])
def test_pixel_shuffle_clip_u8_matches_reference(dtype, scale):
    """Byte-exact against the JAX tail and its Pallas kernel (interpret
    mode), ties and out-of-range values included; on the CPU no kernel
    launches."""
    rng = np.random.default_rng(scale)
    x = rng.uniform(-40, 300, (2, 8, 6, 3 * scale * scale)).astype(np.float32)
    ties = (rng.integers(-3, 258, x.shape) + 0.5).astype(np.float32)
    mask = rng.random(x.shape) < 0.3
    x[mask] = ties[mask]
    xj, xt = _bf16(x) if dtype == "bf16" else (x, torch.from_numpy(x))
    before = tps.quantize_u8.launches
    got = tps.pixel_shuffle_clip_u8(xt, scale).numpy()
    assert tps.quantize_u8.launches == before
    assert got.shape == (2, 8 * scale, 6 * scale, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(jax_pixel_shuffle_clip_u8(
        jnp.asarray(xj), scale)))
    np.testing.assert_array_equal(got, np.asarray(_pallas_shuffle_clip(
        jnp.asarray(xj), scale, interpret=True)))


def test_ycbcr_to_rgb_within_one_ulp_of_255():
    """Plain f32 sums of products against XLA's CPU dot, which may round
    a channel as an fma chain: within one ulp at 255 (3.05e-5), R and G
    exact."""
    rng = np.random.default_rng(8)
    planes = [rng.integers(0, 256, (2, 16, 24)).astype(np.float32)
              for _ in range(3)]
    want = np.asarray(jax.jit(jcs.ycbcr_to_rgb)(*planes))
    got = tcs.ycbcr_to_rgb(*map(torch.from_numpy, planes)).numpy()
    assert got.shape == want.shape == (2, 16, 24, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=3.1e-5)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    # and it inverts rgb_to_ycbcr to within f32 rounding
    back = tcs.ycbcr_to_rgb(*tcs.rgb_to_ycbcr(torch.from_numpy(got))).numpy()
    np.testing.assert_allclose(back, got, rtol=0, atol=2e-3)


def test_pack_s2d_kernel_matches_reference():
    rng = np.random.default_rng(3)
    kernel = rng.standard_normal((3, 3, 8, 12)).astype(np.float32)
    want = np.asarray(jhead.pack_s2d_kernel(jnp.asarray(kernel)))
    got = thead.pack_s2d_kernel(torch.from_numpy(kernel)).numpy()
    assert got.shape == (4, 4, 8, 48)
    np.testing.assert_array_equal(got, want)


def test_s2d_head_matches_reference_f32():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 12, 16, 8)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 8, 12)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    want = np.asarray(jhead.s2d_head(jnp.asarray(feats), jnp.asarray(kernel),
                                     jnp.asarray(bias), jnp.float32))
    got = thead.s2d_head(torch.from_numpy(feats), torch.from_numpy(kernel),
                         torch.from_numpy(bias), torch.float32).numpy()
    assert got.shape == (2, 6, 8, 48)
    # the reference's own tolerance for this head (tests/test_upscale.py)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_s2d_head_matches_reference_bf16():
    """bf16 conv, then + tiled bias in bf16: measured bit-exact against
    XLA's CPU conv on these inputs."""
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 8, 10, 16)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, 16, 12)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    want = np.asarray(jhead.s2d_head(jnp.asarray(feats), jnp.asarray(kernel),
                                     jnp.asarray(bias)), np.float32)
    got = thead.s2d_head(torch.from_numpy(feats), torch.from_numpy(kernel),
                         torch.from_numpy(bias)).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_ycbcr_to_unit_rgb_within_two_ulp():
    """Plain f32 sums of products; XLA's CPU dot rounds the B channel as
    an fma chain, so values differ by at most 2 ulp at magnitude 1
    (2.4e-7 measured) and most match exactly."""
    rng = np.random.default_rng(5)
    planes = [rng.integers(0, 256, (2, 16, 24)).astype(np.float32)
              for _ in range(3)]
    want = np.asarray(jax.jit(jcs.ycbcr_to_unit_rgb)(*planes))
    got = tcs.ycbcr_to_unit_rgb(*map(torch.from_numpy, planes)).numpy()
    assert got.shape == want.shape == (2, 16, 24, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.5e-7)
    # R and G are the same sums in the same order: exact
    np.testing.assert_array_equal(got[..., :2], want[..., :2])


def test_rgb_to_ycbcr_within_one_ulp_of_255():
    rng = np.random.default_rng(6)
    rgb = rng.uniform(0, 255, (2, 8, 8, 3)).astype(np.float32)
    want = jax.jit(jcs.rgb_to_ycbcr)(rgb)
    got = tcs.rgb_to_ycbcr(torch.from_numpy(rgb))
    for w, g in zip(want, got):
        # one ulp in [128, 256) is 2**-16 * 2 = 3.05e-5 (1.5e-5 measured)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=3.1e-5)


def test_upsample_and_downsample_chroma_exact():
    rng = np.random.default_rng(7)
    small = rng.uniform(0, 255, (2, 4, 6)).astype(np.float32)
    up_j = np.asarray(jcs.upsample_chroma(jnp.asarray(small), 2, 2))
    up_t = tcs.upsample_chroma(torch.from_numpy(small), 2, 2).numpy()
    np.testing.assert_array_equal(up_t, up_j)
    full = rng.uniform(0, 255, (2, 8, 12)).astype(np.float32)
    down_j = np.asarray(jax.jit(lambda p: jcs.downsample_chroma(p, 2, 2))(full))
    down_t = tcs.downsample_chroma(torch.from_numpy(full), 2, 2).numpy()
    np.testing.assert_array_equal(down_t, down_j)


def _packed(seed: int, wide_exponents: bool = False, scale: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (2, 10, 12, 12 * scale * scale)
    if wide_exponents:
        # values whose sums and products round differently under any
        # other order of operations
        return (rng.uniform(-1.5, 1.5, shape)
                * 2.0 ** rng.integers(-20, 3, shape)).astype(np.float32)
    return (rng.standard_normal(shape) * 0.6 + 0.3).astype(np.float32)


@pytest.mark.parametrize("scale", [1, 2, 3])
@pytest.mark.parametrize("wide", [False, True])
def test_s2d_tail_plain_byte_exact_vs_reference(wide, scale):
    xj, xt = _bf16(_packed(8, wide, scale))
    want = jax.jit(lambda p: jcs.fused_subpixel_ycc_s2d(p, scale))(jnp.asarray(xj))
    got = tcs.fused_subpixel_ycc_s2d_plain(xt, scale)
    shapes = [(2, 20 * scale, 24 * scale), (2, 20, 24), (2, 20, 24)]
    for w, g, shape in zip(want, got, shapes):
        assert g.shape == shape and g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("scale", [2, 3])
def test_s2d_tail_contractions_bitwise_vs_reference(scale):
    """The pre-quantize f32 values themselves match XLA bit for bit: the
    fma-chain contraction and the sub-pixel mean (summed left to right,
    then times f32(1/r^2): at scale 3 a division differs in the last bit
    on about a tenth of these values)."""
    xj, xt = _bf16(_packed(9, True, scale).reshape(2, 10, 12, 4, scale * scale, 3))
    sub = xt.float()
    for i, row in enumerate((tcs._Y_ROW, tcs._CB_ROW, tcs._CR_ROW)):
        ref_row = 255.0 * jcs._RGB2YCC[i]
        want = np.asarray(jax.jit(lambda s: jnp.matmul(
            s, ref_row, precision="highest"))(jnp.asarray(xj)))
        got = tcs._contract3(sub, row).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    want = np.asarray(jnp.asarray(xj).mean(axis=4, dtype=jnp.float32))
    got = tcs._mean_subpixels(sub, 4).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_s2d_tail_dispatches_plain_on_cpu(scale):
    _, xt = _bf16(_packed(10, scale=scale))
    before = tcs.fused_subpixel_ycc_s2d.launches
    for a, b in zip(tcs.fused_subpixel_ycc_s2d(xt, scale),
                    tcs.fused_subpixel_ycc_s2d_plain(xt, scale)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tcs.fused_subpixel_ycc_s2d.launches == before


@pytest.mark.parametrize("scale", [2, 3])
def test_fused_subpixel_tail_byte_exact_vs_reference(scale):
    rng = np.random.default_rng(11)
    h12 = (rng.standard_normal((2, 6, 8, 3 * scale * scale)) * 0.6
           + 0.3).astype(np.float32)
    want = jcs.fused_subpixel_ycc(jnp.asarray(h12), scale)
    got = tcs.fused_subpixel_ycc(torch.from_numpy(h12), scale)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
