"""The port's model and weight bridge held against the flax model, on
the CPU, with the same (bridged) weights on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from downloader_tpu.compute.models import upscaler as jup
from downloader_tpu_torch.compute.models import upscaler as tup
from downloader_tpu_torch.compute.weights import from_flax, to_flax


def _configs(features: int, depth: int, compute: str):
    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32}[compute]
    tdt = {"bf16": torch.bfloat16, "f32": torch.float32}[compute]
    return (jup.UpscalerConfig(features=features, depth=depth, compute_dtype=jdt),
            tup.UpscalerConfig(features=features, depth=depth, compute_dtype=tdt))


def _flax_params(config, seed: int = 0):
    """A flax param tree for ``config`` drawn with numpy (flax's own init
    costs seconds of XLA compiles; parity only needs the same weights on
    both sides), biases off zero so the bias path counts."""
    rng = np.random.default_rng(seed)
    params = {}
    c_in = config.channels
    shapes = [("stem", 5, c_in, config.features)]
    shapes += [(f"body_{i}", 3, config.features, config.features)
               for i in range(config.depth - 1)]
    shapes.append(("subpixel", 3, config.features,
                   config.channels * config.scale ** 2))
    for name, k, cin, cout in shapes:
        params[name] = {
            "kernel": (rng.standard_normal((k, k, cin, cout))
                       / np.sqrt(k * k * cin)).astype(np.float32),
            "bias": (0.05 * rng.standard_normal(cout)).astype(np.float32),
        }
    return jup.Upscaler(config), {"params": params}


def test_bridge_round_trip_and_layout():
    jcfg, tcfg = _configs(8, 3, "bf16")
    _, params = _flax_params(jcfg)
    state = from_flax(params, tcfg)
    assert set(state) == {f"{m}.{leaf}" for m in ("stem", "body_0", "body_1", "subpixel")
                          for leaf in ("weight", "bias")}
    assert tuple(state["stem.weight"].shape) == (8, 3, 5, 5)       # OIHW
    assert tuple(state["subpixel.weight"].shape) == (12, 8, 3, 3)
    back = to_flax(state, tcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    # every reference param path is covered, and the port derives the same list
    assert tup.param_paths(tcfg) == jup.param_paths(jcfg)
    # a state dict that loads into the port's module unchanged
    tup.Upscaler(tcfg).load_state_dict(state)


def test_bridge_rejects_a_mismatched_tree():
    jcfg, tcfg = _configs(8, 2, "bf16")
    _, params = _flax_params(jcfg)
    with pytest.raises(ValueError):
        from_flax(params, tup.UpscalerConfig(features=8, depth=3))


@pytest.mark.parametrize("compute,features,depth", [
    ("f32", 8, 2), ("f32", 16, 3), ("bf16", 8, 2), ("bf16", 16, 3)])
def test_upscaler_methods_match_flax(compute, features, depth):
    """f32 compute: allclose 1e-5.  bf16 compute: the same conv in the
    same rounding order (cast, conv, round, + bias, relu, + x) measured
    bit-exact against XLA's CPU conv, so the bound is exact equality."""
    jcfg, tcfg = _configs(features, depth, compute)
    model, params = _flax_params(jcfg, seed=features + depth)
    port = tup.Upscaler(tcfg)
    port.load_state_dict(from_flax(params, tcfg))
    rng = np.random.default_rng(features)
    x = rng.uniform(-0.2, 1.2, (2, 10, 14, 3)).astype(np.float32)
    for method, name in ((jup.Upscaler.trunk, "trunk"),
                         (jup.Upscaler.backbone, "backbone"),
                         (jup.Upscaler.__call__, "forward")):
        want = np.asarray(model.apply(params, jnp.asarray(x), method=method),
                          np.float32)
        with torch.no_grad():
            got = getattr(port, name)(torch.from_numpy(x))
        assert got.dtype == tcfg.compute_dtype
        got = got.float().numpy()
        assert got.shape == want.shape
        if compute == "f32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)


def test_seeded_init_is_deterministic_and_lecun_scaled():
    cfg = tup.UpscalerConfig(features=32, depth=2)
    a, b, c = (tup.Upscaler(cfg, seed=s) for s in (3, 3, 4))
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        if name.endswith("bias"):
            assert not pa.any()
        else:
            assert not torch.equal(pa, pc)
    # lecun normal: std ~ sqrt(1/fan_in), truncated at 2 std of the
    # pre-scaled normal
    w = a.body_0.weight
    fan_in = 32 * 3 * 3
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.1
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
