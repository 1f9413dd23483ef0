"""The port's partition rules and mesh plans against the JAX package's —
mirrors ``tests/test_compute_shard.py``'s rules tests (``:55-311``).

The reference's meshes are the 8 virtual CPU devices ``tests/conftest.py``
gives JAX; the port's counterpart is a plan of one process listing the
CPU 8 times.
"""

import contextlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as P  # noqa: E402

from downloader_tpu.compute.models import upscaler as ref_upscaler  # noqa: E402
from downloader_tpu.compute.parallel import mesh as ref_mesh  # noqa: E402
from downloader_tpu.compute.parallel import partition as ref_partition  # noqa: E402
from downloader_tpu_torch.compute import kernels  # noqa: E402
from downloader_tpu_torch.compute.models.upscaler import (  # noqa: E402
    Upscaler,
    UpscalerConfig,
)
from downloader_tpu_torch.compute.parallel import (  # noqa: E402
    UPSCALER_RULES,
    MeshPlan,
    make_global,
    make_mesh,
    match_partition_rules,
    rule_audit,
    spec_for,
)
from downloader_tpu_torch.compute.parallel.partition import Spec  # noqa: E402
from downloader_tpu_torch.compute.weights import to_flax  # noqa: E402

TINY = UpscalerConfig(features=16, depth=2, scale=2)


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
    assert plan.data_spec == Spec("data")
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
