"""The port's partition rules, mesh plans and chooser against the JAX
package's — mirrors ``tests/test_compute_shard.py``'s chooser and rules
tests (``:55-311``).

The reference's meshes are the 8 virtual CPU devices ``tests/conftest.py``
gives JAX; the port's counterpart is a plan of one process listing the
CPU 8 times.  Decisions must be the reference's, strategy and reason.
"""

import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as P  # noqa: E402

from downloader_tpu.compute.models import upscaler as ref_upscaler  # noqa: E402
from downloader_tpu.compute.parallel import chooser as ref_chooser  # noqa: E402
from downloader_tpu.compute.parallel import mesh as ref_mesh  # noqa: E402
from downloader_tpu.compute.parallel import partition as ref_partition  # noqa: E402
from downloader_tpu_torch.compute import kernels  # noqa: E402
from downloader_tpu_torch.compute.models.upscaler import (  # noqa: E402
    Upscaler,
    UpscalerConfig,
)
from downloader_tpu_torch.compute.parallel import (  # noqa: E402
    Decision,
    UPSCALER_RULES,
    MeshPlan,
    choose,
    compile_step,
    decision_cache,
    make_global,
    make_mesh,
    match_partition_rules,
    rule_audit,
    spec_for,
)
from downloader_tpu_torch.compute.parallel.chooser import clear_decisions  # noqa: E402
from downloader_tpu_torch.compute.parallel.partition import Spec  # noqa: E402
from downloader_tpu_torch.compute.pipeline import FrameUpscaler  # noqa: E402
from downloader_tpu_torch.compute.weights import to_flax  # noqa: E402

TINY = UpscalerConfig(features=16, depth=2, scale=2)


@pytest.fixture(autouse=True)
def _fresh_decisions():
    clear_decisions()
    ref_chooser.clear_decisions()
    yield
    clear_decisions()
    ref_chooser.clear_decisions()


def _plans(model_axis):
    """The port's plan and the reference's mesh of 8 devices."""
    return (MeshPlan.over(["cpu"] * 8, model_axis),
            ref_mesh.make_mesh(8, model_axis=model_axis).mesh)


# ---------------------------------------------------------------- chooser

def _pair(decision) -> tuple:
    return (decision.strategy, decision.reason)


def test_chooser_no_mesh_is_jit():
    got = choose(None, (8,), explicit_shardings=False)
    assert _pair(got) == _pair(ref_chooser.choose(None, (8,),
                                                  explicit_shardings=False))
    assert got.strategy == "jit"


def test_chooser_single_device_plan_is_jit():
    ref = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                            ("data", "model"))
    got = choose(MeshPlan.over(["cpu"]), (8,), explicit_shardings=False)
    assert _pair(got) == _pair(ref_chooser.choose(ref, (8,),
                                                  explicit_shardings=False))
    assert got.strategy == "jit"


@pytest.mark.parametrize("model_axis", [1, 2, 4, 8])
@pytest.mark.parametrize("batch_shape", [(8,), (7,), (16,), (2,), None])
@pytest.mark.parametrize("explicit", [False, True])
def test_chooser_decisions_equal_the_reference(model_axis, batch_shape, explicit):
    """For each mesh shape, batch and sharding flag the port's Decision
    is the reference's, strategy and reason."""
    plan, mesh = _plans(model_axis)
    got = choose(plan, batch_shape, explicit_shardings=explicit)
    want = ref_chooser.choose(mesh, batch_shape, explicit_shardings=explicit)
    assert isinstance(got, Decision)
    assert _pair(got) == _pair(want)


def test_chooser_decisions_pinned_per_shape_and_mesh():
    """One decision per (shape, mesh), cached — a re-ask is a hit."""
    plan = MeshPlan.over(["cpu"] * 8, 2)
    expected = {
        (None, (8,)): "jit",
        (plan, (8,)): "shard_map",
        (plan, (7,)): "pjit",
        (plan, None): "pjit",
    }
    for (mesh, shape), strategy in expected.items():
        assert choose(mesh, shape, explicit_shardings=False).strategy == strategy
    assert len(decision_cache()) == len(expected)
    before = choose(plan, (8,), explicit_shardings=False)
    assert choose(plan, (8,), explicit_shardings=False) is before
    # keyed on (axis names, grid shape): another plan of that shape hits
    assert choose(MeshPlan.over(["cpu"] * 8, 2), (8,),
                  explicit_shardings=False) is before


def test_compile_step_shard_map_requires_specs():
    with pytest.raises(ValueError, match="in_specs/out_specs"):
        compile_step(lambda x: x, MeshPlan.over(["cpu"] * 8, 2), batch_shape=(8,))


@pytest.mark.parametrize("model_axis", [1, 2])
def test_compile_step_shard_map_route_executes(model_axis):
    """The reference's shard_map route does not run on this tree (its
    ``check_rep``); the port's is held against the single-device output:
    one call per data shard, each on its own rows, rows joined in order."""
    plan = MeshPlan.over(["cpu"] * 8, model_axis)
    seen = []

    def per_shard(scale, x):
        seen.append(tuple(x.tolist()))
        return x * scale

    fn, decision = compile_step(per_shard, plan, batch_shape=(8,),
                                in_specs=(Spec(), Spec("data")),
                                out_specs=Spec("data"))
    assert decision.strategy == "shard_map"
    x = torch.arange(8.0)
    np.testing.assert_array_equal(fn(2.0, x).numpy(), (x * 2.0).numpy())
    data = 8 // model_axis
    assert seen == [tuple(c.tolist()) for c in x.chunk(data)]


def test_compile_step_jit_and_pjit_return_the_function_and_refuse_model_specs():
    def fn(x):
        return x

    assert compile_step(fn, None) == (fn, Decision(
        "jit", "single device: no mesh to map over"))
    plan = MeshPlan.over(["cpu"] * 4, 2)
    got, decision = compile_step(fn, plan, in_shardings=(Spec("data"),),
                                 donate_argnums=(0,))
    assert got is fn and decision.strategy == "pjit"
    with pytest.raises(ValueError, match="only over 'data'"):
        compile_step(fn, plan, batch_shape=(4,), in_specs=(Spec("model"),),
                     out_specs=Spec("data"))


# -------------------------------------------------------- partition table

@pytest.fixture(scope="module")
def port_params():
    return Upscaler(TINY, seed=0).state_dict()


def test_every_upscaler_param_matches_exactly_one_rule(port_params):
    audit = rule_audit(UPSCALER_RULES, port_params)
    assert sorted(audit) == sorted(port_params)
    bad = {name: pats for name, pats in audit.items() if len(pats) != 1}
    assert not bad, f"params without exactly one rule: {bad}"


def test_param_names_follow_the_reference_paths(port_params):
    """Every state-dict name is a reference leaf path through the weight
    bridge's naming (``params/<module>/kernel`` <-> ``<module>.weight``)."""
    bridged = sorted("params/" + name.replace(".weight", "/kernel")
                     .replace(".bias", "/bias").replace(".", "/")
                     for name in port_params)
    assert bridged == sorted(ref_upscaler.param_paths(
        ref_upscaler.UpscalerConfig(features=16, depth=2, scale=2)))


# flax HWIO -> torch OIHW, as weights.from_flax transposes kernels
_OIHW_FROM_HWIO = (3, 2, 0, 1)


def test_each_split_is_the_reference_spec_through_the_weight_bridge(port_params):
    """Each param's Spec is the reference's PartitionSpec for its flax
    leaf, with the kernel's dims permuted as ``from_flax`` permutes
    them: the trunk kernels' cout (HWIO's last dim) is OIHW's first."""
    ref_specs = ref_partition.match_partition_rules(
        ref_partition.UPSCALER_RULES, to_flax(port_params, TINY))["params"]
    specs = match_partition_rules(UPSCALER_RULES, port_params)
    for name, spec in specs.items():
        module, leaf = name.split(".")
        ref = tuple(ref_specs[module]["kernel" if leaf == "weight" else "bias"])
        if leaf == "weight" and ref:
            ref = tuple(ref[i] for i in _OIHW_FROM_HWIO)
        assert tuple(spec) == ref, (name, spec, ref)
    assert specs["stem.weight"] == Spec("model", None, None, None)
    assert specs["body_0.bias"] == Spec("model")
    assert specs["subpixel.weight"] == specs["subpixel.bias"] == Spec()
    assert ref_specs["stem"]["kernel"] == P(None, None, None, "model")


def test_unmatched_param_raises():
    with pytest.raises(ValueError, match="Partition rule not found for param"):
        spec_for(UPSCALER_RULES, "mystery.weight", np.zeros((4, 4, 3, 3)))
    with pytest.raises(ValueError, match="norm.scale"):
        match_partition_rules(UPSCALER_RULES, {"norm.scale": np.zeros((16,))})


def test_scalar_leaves_replicate_without_a_rule():
    assert spec_for(UPSCALER_RULES, "step", torch.tensor(0.0)) == Spec()
    assert spec_for(ref_partition.UPSCALER_RULES, "count", np.asarray(0)) == P()


# ------------------------------------------------------------ mesh plans

def test_make_mesh_errors_are_the_reference_s():
    with pytest.raises(ValueError, match="asked for 2 devices, have 1"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by model axis 2"):
        MeshPlan.over(["cpu"] * 3, 2)
    with pytest.raises(ValueError, match="asked for 9 devices, have 8"):
        ref_mesh.make_mesh(9)
    plan = make_mesh(device="cpu")
    assert (plan.shape, plan.size, plan.coords, plan.device) == (
        {"data": 1, "model": 1}, 1, (0, 0), torch.device("cpu"))
    assert plan.mesh is None and plan.group("data") is None


def test_plan_shape_and_specs():
    plan = MeshPlan.over(["cpu"] * 8, 2)
    assert plan.shape == dict(ref_mesh.make_mesh(8, model_axis=2).mesh.shape)
    assert plan.data_spec == Spec("data") and plan.replicated == Spec()
    assert plan.param_spec("body_1.weight", np.zeros((4, 4, 3, 3))) == \
        Spec("model", None, None, None)


def test_make_global_takes_one_process_s_block():
    """A plan of one device takes the whole value, as a copy; a plan of
    one process over several devices places its shards itself."""
    value = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = make_global(value, MeshPlan.over(["cpu"]), Spec("data"))
    np.testing.assert_array_equal(got.numpy(), value)
    src = torch.zeros(3)
    assert make_global(src, make_mesh(device="cpu")).data_ptr() != src.data_ptr()
    with pytest.raises(ValueError, match="places its shards itself"):
        make_global(value, MeshPlan.over(["cpu"] * 2), Spec("data"))


# ----------------------------------------------------------------- engine

def test_engine_records_compile_decisions():
    """Mirrors ``test_engine_bills_three_hops_and_caches_decisions``: the
    chooser's verdict per (sub_h, sub_w) is kept on the engine — pjit
    over several devices (the engine places its shards), jit on one —
    and equals the reference's for the same mesh and batch."""
    config = UpscalerConfig(features=8, depth=2)
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (3, 8, 8), dtype=np.uint8)
    c = rng.integers(0, 256, (3, 4, 4), dtype=np.uint8)
    for devices, strategy in ((["cpu"] * 4, "pjit"), (["cpu"], "jit")):
        engine = FrameUpscaler(config, batch=3, devices=devices)
        engine.upscale_batch(y, c, c, 2, 2)
        got = engine.compile_decisions[(2, 2)]
        ref = jax.sharding.Mesh(
            np.array(jax.devices()[:len(devices)]).reshape(len(devices)),
            ("data",))
        want = ref_chooser.choose(ref, (engine.batch,),
                                  explicit_shardings=len(devices) > 1)
        assert _pair(got) == _pair(want)
        assert got.strategy == strategy


# ---------------------------------------------- the launch-device repair

def test_same_device_names_the_mixed_operands():
    a, b = torch.zeros(2), torch.zeros(2, device="meta")
    assert kernels.same_device("k", x=a, y=a) == torch.device("cpu")
    with pytest.raises(ValueError, match="x on cpu, y on meta"):
        kernels.same_device("k", x=a, y=b)


def test_launch_makes_the_operands_device_current(monkeypatch):
    """``kernels.launch`` calls the C entry point with the operands'
    device current and that device's stream last; a non-zero code
    raises.  (The card's own check is ``test_kernels_launch_on_their
    operands_card``.)"""
    current = []

    @contextlib.contextmanager
    def device(dev):
        current.append(dev)
        try:
            yield
        finally:
            current.pop()

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: f"stream of {dev}")
    calls = []

    def entry(*args):
        calls.append((list(current), args))
        return 0

    dev = torch.device("cuda", 1)
    kernels.launch(entry, "k", dev, 7, 8)
    assert calls == [([dev], (7, 8, "stream of cuda:1"))]
    assert current == []
    with pytest.raises(RuntimeError, match="k failed to launch: cudaError 3"):
        kernels.launch(lambda *args: 3, "k", dev)


@pytest.mark.cuda
def test_kernels_launch_on_their_operands_card():
    """A kernel on ``cuda:1`` while device 0 is current launches on card
    1 and matches its plain version; mixed-device operands raise."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    from downloader_tpu_torch.compute.ops import colorspace, pixel_shuffle, s2d_head

    torch.cuda.set_device(0)
    x = (torch.rand((2, 6, 8, 48)) * 4 - 2).to(torch.bfloat16)
    got = colorspace.fused_subpixel_ycc_s2d(x.to("cuda:1"), 2)
    for g, w in zip(got, colorspace.fused_subpixel_ycc_s2d_plain(x, 2)):
        assert g.device == torch.device("cuda", 1)
        assert torch.equal(g.cpu(), w)
    q = torch.rand(1000) * 300 - 20
    assert torch.equal(pixel_shuffle.quantize_u8(q.to("cuda:1")).cpu(),
                       pixel_shuffle.quantize_u8_plain(q))
    feats = torch.zeros((1, 8, 8, 128), dtype=torch.bfloat16, device="cuda:0")
    k4 = torch.zeros((4, 4, 128, 48), dtype=torch.bfloat16, device="cuda:1")
    with pytest.raises(ValueError, match="several devices"):
        s2d_head.s2d_head_kernel(feats, k4, k4[0, 0, 0].clone())
