"""The port's s2d head kernel (plain version, on the CPU) held against the
JAX package's Pallas spike, ``scripts/pallas_head_spike.py``, run
unedited in Pallas interpret mode; and against a float64 reference and
the engine's cuDNN head.  The kernel itself is held against the plain
version on the card by ``tests/test_torch_kernels.py`` and
``chip_smoke.py``."""

import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
from downloader_tpu_torch.compute.ops import s2d_head as thead
from downloader_tpu_torch.compute.weights import from_flax
from downloader_tpu_torch.scripts import head_spike

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the head's own widths; one body layer keeps the flax-shaped tree small
CONFIG = UpscalerConfig(depth=2)


@pytest.fixture(scope="module")
def spike():
    """The spike module, loaded from its file and run in interpret mode:
    its ``pl`` is swapped for a namespace whose ``pallas_call`` passes
    ``interpret=True``; the file itself is not edited."""
    path = os.path.join(REPO, "scripts", "pallas_head_spike.py")
    spec = importlib.util.spec_from_file_location("pallas_head_spike", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    return module


def _flax_tree(rng, bias_scale=0.0):
    """A flax-shaped param tree of CONFIG: lecun-normal-sized kernels and
    (as flax initializes them) zero biases, unless ``bias_scale``."""
    params = {}
    for name, size, cin, cout in (("stem", 5, 3, 128), ("body_0", 3, 128, 128),
                                  ("subpixel", 3, 128, 12)):
        fan_in = size * size * cin
        params[name] = {
            "kernel": (rng.standard_normal((size, size, cin, cout))
                       / np.sqrt(fan_in)).astype(np.float32),
            "bias": (rng.standard_normal(cout) * bias_scale).astype(np.float32),
        }
    return {"params": params}


def _packed_head(tree):
    """k4/bias4 in bf16 from the tree's subpixel head, through the port's
    weight bridge and :func:`pack_s2d_kernel`, as the spike builds them."""
    state = from_flax(tree, CONFIG)
    kernel = state["subpixel.weight"].permute(2, 3, 1, 0)  # OIHW -> HWIO
    k4 = thead.pack_s2d_kernel(kernel).to(torch.bfloat16).contiguous()
    bias4 = state["subpixel.bias"].repeat(4).to(torch.bfloat16)
    return kernel, state["subpixel.bias"], k4, bias4


def _bf16_feats(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(torch.bfloat16)


def _to_jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy().astype(ml_dtypes.bfloat16))


def _ulp_steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 ulps: the distance of the two values on the
    ordered line of bf16 bit patterns (+0 and -0 both at 0)."""
    def ordered(t):
        bits = t.to(torch.bfloat16).view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def test_spike_in_interpret_mode_matches_plain_byte_for_byte(spike):
    """The spike's function is the plain version's: the sum over the 16
    taps of the SAME-padded stride-2 window, the bias added in f32, one
    rounding to bf16.  The inputs sit on coarse grids (features k/8,
    weights k/64, biases k/64, |k| <= 64), so every partial sum is exact
    in f32 and the order of summation cannot show: what is compared is
    the function alone, and all 24,576 values are the same — ties to
    even included.  (On the spike's own block-aligned shape class,
    H/2 % 8 == 0 and W/2 % 64 == 0.)"""
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.integers(-8, 9, (1, 16, 128, 128))
                             .astype(np.float32) / 8).to(torch.bfloat16)
    tree = _flax_tree(rng)
    sub = tree["params"]["subpixel"]
    sub["kernel"] = (rng.integers(-8, 9, sub["kernel"].shape) / 64).astype(np.float32)
    sub["bias"] = (rng.integers(-64, 65, sub["bias"].shape) / 64).astype(np.float32)
    kernel, bias, k4, bias4 = _packed_head(tree)
    want = np.asarray(spike.pallas_s2d_head(_to_jax(feats), _to_jax(k4),
                                            _to_jax(bias4)), np.float32)
    got = thead.s2d_head_kernel_plain(feats, k4, bias4)
    assert got.shape == (1, 8, 64, 48) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the inputs do reach the single rounding, and the engine's head,
    # which rounds twice, differs from the spike on them
    exact_sums = (thead.s2d_head_kernel_plain(feats, k4, bias4, torch.float32)
                  .numpy())
    assert (exact_sums != want).any()
    assert (thead.s2d_head(feats, kernel, bias).float().numpy() != want).any()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_spike_matches_plain_within_one_ulp_on_other_inputs(spike, seed):
    """On other inputs the two can differ by one ulp on a few values: the
    spike sums in f32 (each tap's dot in XLA's order, then tap by tap),
    the plain version in float64, and a sum that lands next to a bf16
    rounding boundary can tip either way (measured 2-4 of 24,576)."""
    rng = np.random.default_rng(seed)
    feats = _bf16_feats(rng, (1, 16, 128, 128))
    _, _, k4, bias4 = _packed_head(_flax_tree(rng, bias_scale=0.1))
    want = torch.from_numpy(np.asarray(spike.pallas_s2d_head(
        _to_jax(feats), _to_jax(k4), _to_jax(bias4)), np.float32))
    got = thead.s2d_head_kernel_plain(feats, k4, bias4)
    steps = _ulp_steps(got, want)
    assert int(steps.max()) <= 1
    assert float((steps == 0).double().mean()) > 0.999


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_plain_head_on_a_ragged_shape_matches_float64(out_dtype):
    """H/2 = 9 and W/2 = 17, a shape the spike refuses (its blocks need
    H/2 % 8 == 0, W/2 % 64 == 0) and the kernel takes (its edge blocks
    mask): the plain version against an independent float64 reference,
    a direct sum over the SAME-padded window, rounded once."""
    rng = np.random.default_rng(4)
    feats = _bf16_feats(rng, (2, 18, 34, 128))
    k4 = torch.from_numpy(rng.standard_normal((4, 4, 128, 48)).astype(np.float32)
                          * 0.03).to(torch.bfloat16)
    bias4 = torch.from_numpy(rng.standard_normal(48).astype(np.float32)
                             ).to(torch.bfloat16)
    x = np.pad(feats.double().numpy(), ((0, 0), (1, 1), (1, 1), (0, 0)))
    k = k4.double().numpy()
    want = np.zeros((2, 9, 17, 48))
    for i in range(9):
        for j in range(17):
            window = x[:, 2 * i:2 * i + 4, 2 * j:2 * j + 4, :]  # (b, u, v, c)
            want[:, i, j] = np.einsum("buvc,uvcn->bn", window, k)
    want = torch.from_numpy(want + bias4.double().numpy()).float().to(out_dtype)
    got = thead.s2d_head_kernel_plain(feats, k4, bias4, out_dtype)
    assert got.shape == (2, 9, 17, 48) and got.dtype == out_dtype
    assert torch.equal(got, want)


def test_plain_head_within_one_ulp_of_engine_head():
    """The engine's head (``s2d_head``) rounds the conv to bf16 and then
    rounds again after adding a bf16 bias; the kernel's function adds
    the f32 bias to the f32 sum and rounds once.  One rounding against
    two: they differ by at most one bf16 ulp at the magnitude where the
    first rounding happens (the conv's, or the output's if larger — near
    a zero of conv + bias that ulp is many of the output's own), and
    agree on most values (76.7% here; the JAX package's spike against
    its own ``s2d_head`` differs the same way)."""
    rng = np.random.default_rng(5)
    feats = _bf16_feats(rng, (2, 16, 24, 128))
    kernel, bias, k4, bias4 = _packed_head(_flax_tree(rng, bias_scale=0.02))
    engine = thead.s2d_head(feats, kernel, bias)
    plain = thead.s2d_head_kernel_plain(feats, k4, bias4)
    assert engine.shape == plain.shape == (2, 8, 12, 48)
    conv = thead.s2d_head_kernel_plain(feats, k4, torch.zeros_like(bias4),
                                       torch.float32)
    _, exp = torch.frexp(torch.maximum(conv.abs(), plain.float().abs()))
    ulp = torch.ldexp(torch.ones_like(conv), exp - 8)  # bf16 keeps 8 bits
    assert bool(((engine.float() - plain.float()).abs() <= ulp).all())
    steps = _ulp_steps(plain, engine)
    assert float((steps == 0).double().mean()) > 0.7
    # the second rounding is real: with a zero bias the two agree more
    zero = thead.s2d_head(feats, kernel, torch.zeros_like(bias))
    plain0 = thead.s2d_head_kernel_plain(feats, k4, torch.zeros_like(bias4))
    assert (_ulp_steps(plain0, zero) == 0).double().mean() > (steps == 0).double().mean()


def test_head_kernel_dispatches_plain_on_cpu():
    rng = np.random.default_rng(6)
    feats = _bf16_feats(rng, (1, 4, 6, 128))
    _, _, k4, bias4 = _packed_head(_flax_tree(rng))
    before = thead.s2d_head_kernel.launches
    assert torch.equal(thead.s2d_head_kernel(feats, k4, bias4),
                       thead.s2d_head_kernel_plain(feats, k4, bias4))
    assert thead.s2d_head_kernel.launches == before  # no kernel on the CPU


def test_head_weight_repack_is_the_kernels_layout_and_round_trips():
    """The wrapper's weight repack, as the kernel reads it: tap u*4+v,
    then output channel n, then input channel c contiguous, so that 32
    channels of 4 taps are one TMA box whose 64-byte rows are K-major for
    wgmma's B operand.  Pure indexing: it round-trips to k4 exactly."""
    rng = np.random.default_rng(7)
    k4 = torch.from_numpy(rng.standard_normal((4, 4, 128, 48)).astype(np.float32)
                          ).to(torch.bfloat16)
    w16 = thead.repack_k4(k4)
    assert w16.shape == (16, 48, 128) and w16.dtype == torch.bfloat16
    assert w16.is_contiguous()
    for u, v, c, n in ((0, 0, 0, 0), (1, 2, 37, 5), (3, 3, 127, 47), (2, 1, 64, 24)):
        assert torch.equal(w16[u * 4 + v, n, c], k4[u, v, c, n])
    # a TMA box of step (chunk, tap row u) is w16[4u:4u+4, :, 32*chunk:+32]
    box = w16.view(4, 4, 48, 4, 32)[2, :, :, 1]
    assert torch.equal(box, k4[2, :, 32:64, :].transpose(1, 2))
    assert torch.equal(w16.reshape(4, 4, 48, 128).transpose(2, 3), k4)
    assert torch.equal(w16.view(torch.int16).flatten().sort().values,
                       k4.view(torch.int16).flatten().sort().values)


def test_head_spike_check_on_cpu(capsys):
    """The port's spike entry, as ``python -m
    downloader_tpu_torch.scripts.head_spike check --device cpu`` runs it:
    the spike's three lines, within one ulp of the engine's head."""
    assert head_spike.main(["check", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu"
    assert lines[1] == "shapes: (2, 32, 128, 48) (2, 32, 128, 48)"
    assert float(lines[2].split(":")[1]) <= 2 ** -7  # one ulp below |2|
    assert float(lines[3].split(":")[1]) > 0.999


def test_head_spike_race_needs_the_card():
    with pytest.raises(SystemExit):
        head_spike.main(["race", "--device", "cpu"])
