"""The port's train step and checkpoints, on the CPU, held against the
JAX package's (``downloader_tpu/compute/train.py``,
``downloader_tpu/compute/checkpoint.py``) on the same weights and data.

Weights are flax trees drawn with numpy and bridged into the port with
``from_flax``; data comes from numpy seeds.  The JAX step runs under a
plain ``jax.jit``, on one device.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from downloader_tpu.compute import checkpoint as jckpt
from downloader_tpu.compute.models.upscaler import UpscalerConfig as JaxConfig
from downloader_tpu.compute.train import make_train_step as jax_make_train_step
from downloader_tpu_torch.compute import checkpoint as tckpt
from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
from downloader_tpu_torch.compute.parallel import MeshPlan
from downloader_tpu_torch.compute.pipeline import FrameUpscaler
from downloader_tpu_torch.compute.train import (
    compile_train_step,
    make_optimizer,
    make_train_step,
)
from downloader_tpu_torch.compute.weights import from_flax

TINY = UpscalerConfig(features=16, depth=2)


def _flax_params(config: JaxConfig, seed: int = 0):
    """A flax param tree for ``config`` drawn with numpy, biases off
    zero."""
    rng = np.random.default_rng(seed)
    shapes = [("stem", 5, config.channels, config.features)]
    shapes += [(f"body_{i}", 3, config.features, config.features)
               for i in range(config.depth - 1)]
    shapes.append(("subpixel", 3, config.features,
                   config.channels * config.scale ** 2))
    return {"params": {
        name: {"kernel": (rng.standard_normal((k, k, cin, cout))
                          / np.sqrt(k * k * cin)).astype(np.float32),
               "bias": (0.05 * rng.standard_normal(cout)).astype(np.float32)}
        for name, k, cin, cout in shapes}}


def _batch(n, h, w, scale, seed):
    """Low-res inputs and a learnable high-res target: the inputs
    upsampled, plus noise."""
    rng = np.random.default_rng(seed)
    low = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    high = low.repeat(scale, 1).repeat(scale, 2)
    high = (high + 0.05 * rng.standard_normal(high.shape)).astype(np.float32)
    return low, high


def _port_state(config, tree, lr):
    train_step, init_state = make_train_step(config, learning_rate=lr,
                                             device="cpu")
    state = init_state(seed=1)
    state.model.load_state_dict(from_flax(tree, config))
    return train_step, state


def test_train_step_reduces_loss():
    """Mirrors tests/test_compute.py::test_train_step_reduces_loss."""
    train_step, init_state = make_train_step(TINY, learning_rate=3e-3,
                                             device="cpu")
    state = init_state(0)
    low = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (4, 8, 8, 3)).astype(np.float32))
    high = low.repeat_interleave(2, 1).repeat_interleave(2, 2)
    losses = [float(train_step(state, low, high)) for _ in range(12)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("route", ["no-mesh", "one-device-plan",
                                   "one-process-two-devices"])
def test_compile_train_step_routes(route):
    """Without a process group ``compile_train_step`` is the plain step:
    with no mesh its loss is ``make_train_step``'s on the same seed and
    batch, on a one-device plan it runs on the plan's device and returns
    that plan, and a plan of one process over two devices raises."""
    if route == "one-process-two-devices":
        with pytest.raises(ValueError, match="one process per device"):
            compile_train_step(TINY, mesh=MeshPlan.over(["cpu"] * 2))
        return
    low, high = (torch.from_numpy(a) for a in _batch(2, 8, 8, 2, seed=3))
    plain_step, plain_init = make_train_step(TINY, device="cpu")
    want = plain_step(plain_init(2), low, high)
    if route == "no-mesh":
        step, init_state, plan = compile_train_step(TINY, device="cpu")
        assert plan is None
        home = torch.device("cpu")
    else:
        mesh = MeshPlan.over(["cpu"])
        step, init_state, plan = compile_train_step(TINY, mesh=mesh)
        assert plan is mesh
        home = mesh.device
    state = init_state(2)
    assert next(state.model.parameters()).device == home
    loss = step(state, low, high)
    assert loss.device == home
    assert float(loss) == float(want)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_train_step_tracks_jax_for_ten_steps(compute):
    """The same init and batch through both steps for 10 steps.

    f32: losses within 2e-5 relative and params within 1e-5 of each
    tensor's max |value| (the two frameworks sum the conv gradients and
    the MSE in other orders; 6.5e-6 and 1.1e-6 measured).  bf16: the
    first loss within 1e-6 relative (the forwards are bit-exact; XLA sums
    the MSE in another order: 6.2e-7 measured, the same at 1, 3 and 8
    threads), the later ones within 1e-3 (1.5e-4 measured: bf16
    gradients that differ by an ulp change the Adam step of a near-zero
    gradient by a whole learning rate).  bf16 params are not compared:
    that drift is largest in the zero-mean biases and says nothing of the
    loss."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    jcfg = JaxConfig(features=16, depth=3, compute_dtype=jdt)
    tcfg = UpscalerConfig(features=16, depth=3, compute_dtype=tdt)
    tree = _flax_params(jcfg, seed=3)
    lr = 1e-3
    low, high = _batch(4, 8, 8, 2, seed=4)

    jstep, _ = jax_make_train_step(jcfg, learning_rate=lr)
    jstep = jax.jit(jstep)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = optax.adam(lr).init(params)
    tstep, state = _port_state(tcfg, tree, lr)

    want, got = [], []
    for _ in range(10):
        params, opt_state, loss = jstep(params, opt_state, low, high)
        want.append(float(loss))
        got.append(float(tstep(state, torch.from_numpy(low),
                               torch.from_numpy(high))))
    want, got = np.array(want), np.array(got)
    assert want[-1] < want[0]
    rel = np.abs(got - want) / want
    if compute == "f32":
        assert rel.max() < 2e-5, rel
        ported = from_flax(jax.tree_util.tree_map(np.asarray, params), tcfg)
        for name, value in state.model.state_dict().items():
            scale = float(ported[name].abs().max())
            diff = float((value - ported[name]).abs().max())
            assert diff <= 1e-5 * scale, (name, diff, scale)
    else:
        assert rel[0] < 1e-6, rel
        assert rel.max() < 1e-3, rel


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16])
def test_every_param_gets_a_nonzero_grad(compute):
    """The checkpointed forward returns every parameter's gradient (the
    reentrant variant would return none here, since the input needs no
    grad, and say nothing)."""
    config = UpscalerConfig(features=8, depth=3, compute_dtype=compute)
    train_step, init_state = make_train_step(config, device="cpu")
    state = init_state(0)
    low, high = _batch(2, 6, 6, 2, seed=5)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    train_step(state, torch.from_numpy(low), torch.from_numpy(high))
    for name, param in state.model.named_parameters():
        assert param.grad is not None, name
        assert float(param.grad.abs().max()) > 0, name
        assert not torch.equal(param.detach(), before[name]), name


def _trained_state(config=TINY, steps=3, seed=7):
    train_step, init_state = make_train_step(config, device="cpu")
    state = init_state(seed)
    low, high = map(torch.from_numpy, _batch(2, 8, 8, 2, seed=8))
    for _ in range(steps):
        train_step(state, low, high)
    return train_step, init_state, state, (low, high)


def _equal_state_dicts(a, b):
    """Bit equality of two (nested) state dicts."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_state_dicts(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_state_dicts(x, y) for x, y in zip(a, b))
    return a == b


def test_checkpoint_round_trip_is_bit_exact_and_next_step_matches(tmp_path):
    """Mirrors tests/test_compute.py::test_checkpoint_save_restore_roundtrip:
    save after 3 steps, restore into a fresh state of another seed, then
    one more step from both states agrees bit for bit."""
    train_step, init_state, state, (low, high) = _trained_state()
    ckpt = str(tmp_path / "ckpt")
    assert tckpt.save_state(ckpt, 3, state.model.state_dict(),
                            state.optimizer.state_dict())
    assert tckpt.latest_step(ckpt) == 3
    assert os.listdir(ckpt) == ["3"]
    assert os.listdir(os.path.join(ckpt, "3")) == [tckpt.STATE_FILE]

    fresh = init_state(99)
    step, params, opt_state = tckpt.restore_state(ckpt, fresh.model.state_dict())
    assert step == 3
    fresh.model.load_state_dict(params)
    tckpt.load_optimizer_state(fresh.optimizer, opt_state)
    assert _equal_state_dicts(fresh.model.state_dict(), state.model.state_dict())
    assert _equal_state_dicts(fresh.optimizer.state_dict(),
                              state.optimizer.state_dict())

    l1 = train_step(state, low, high)
    l2 = train_step(fresh, low, high)
    assert float(l1) == float(l2)
    assert _equal_state_dicts(fresh.model.state_dict(), state.model.state_dict())


def test_checkpoint_keeps_the_last_three_steps(tmp_path):
    _, _, state, _ = _trained_state(steps=1)
    ckpt = str(tmp_path / "ckpt")
    params, opt = state.model.state_dict(), state.optimizer.state_dict()
    for step in (2, 4, 6, 8, 10):
        assert tckpt.save_state(ckpt, step, params, opt)
    assert sorted(os.listdir(ckpt), key=int) == ["6", "8", "10"]
    assert tckpt.latest_step(ckpt) == 10
    # a step at or below the latest is not written again (orbax's rule)
    assert not tckpt.save_state(ckpt, 10, params, opt)
    assert not tckpt.save_state(ckpt, 7, params, opt)
    assert sorted(os.listdir(ckpt), key=int) == ["6", "8", "10"]
    assert tckpt.restore_state(ckpt, params, step=8)[0] == 8
    with pytest.raises(FileNotFoundError):
        tckpt.restore_state(ckpt, params, step=4)


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A crash while a step is written leaves no step that latest_step
    would pick, and no temporary directory; a temporary left by a killed
    process is ignored."""
    _, _, state, _ = _trained_state(steps=1)
    ckpt = str(tmp_path / "ckpt")
    params, opt = state.model.state_dict(), state.optimizer.state_dict()
    assert tckpt.save_state(ckpt, 1, params, opt)

    def crash(obj, fh):
        fh.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.torch, "save", crash)
    with pytest.raises(OSError, match="disk full"):
        tckpt.save_state(ckpt, 2, params, opt)
    monkeypatch.undo()
    assert os.listdir(ckpt) == ["1"]
    assert tckpt.latest_step(ckpt) == 1

    os.makedirs(os.path.join(ckpt, ".5.tmp-killed"))  # a SIGKILLed writer's
    assert tckpt.latest_step(ckpt) == 1
    assert tckpt.restore_state(ckpt, params)[0] == 1


def test_missing_checkpoint_raises_file_not_found(tmp_path):
    params = FrameUpscaler(TINY, device="cpu").model.state_dict()
    for directory in (tmp_path, tmp_path / "absent"):
        assert tckpt.latest_step(str(directory)) is None
        with pytest.raises(FileNotFoundError):
            tckpt.restore_state(str(directory), params)
        with pytest.raises(FileNotFoundError):
            FrameUpscaler(TINY, device="cpu", checkpoint_dir=str(directory))


def test_orbax_checkpoint_raises_value_error_naming_the_format(tmp_path):
    """What of the JAX package's orbax steps still raises, in every
    reader, naming the format: a step of another geometry (and the key
    that does not fit), and a truncated step; neither is read as an empty
    directory.  The writer writes beside orbax steps, never at or below
    the latest of them."""
    jcfg = JaxConfig(features=16, depth=2)
    tree = jax.tree_util.tree_map(jnp.asarray, _flax_params(jcfg))
    ckpt = str(tmp_path / "orbax")
    jckpt.save_state(ckpt, 4, tree, optax.adam(1e-3).init(tree))
    other = UpscalerConfig(features=8, depth=2)
    params = FrameUpscaler(other, device="cpu").model.state_dict()
    assert tckpt.latest_step(ckpt) == 4
    with pytest.raises(ValueError, match=r"orbax[\s\S]*stem\.weight"):
        tckpt.restore_state(ckpt, params)
    with pytest.raises(ValueError, match="orbax"):
        FrameUpscaler(other, device="cpu", checkpoint_dir=ckpt)

    truncated = str(tmp_path / "truncated")
    shutil.copytree(ckpt, truncated)
    data = [os.path.join(d, f) for d, _, files in
            os.walk(os.path.join(truncated, "4", "params")) for f in files
            if os.path.basename(d) == "d"]
    biggest = max(data, key=os.path.getsize)
    with open(biggest, "r+b") as fh:
        fh.truncate(os.path.getsize(biggest) // 2)
    tiny = FrameUpscaler(TINY, device="cpu").model.state_dict()
    assert tckpt.latest_step(truncated) == 4
    with pytest.raises(ValueError, match="orbax"):
        tckpt.restore_state(truncated, tiny)
    with pytest.raises(ValueError, match="orbax"):
        FrameUpscaler(TINY, device="cpu", checkpoint_dir=truncated)

    assert not tckpt.save_state(ckpt, 4, tiny, {})
    assert tckpt.save_state(ckpt, 5, tiny, {})
    assert sorted(os.listdir(ckpt)) == ["4", "5"]


def test_foreign_step_directory_raises(tmp_path):
    os.makedirs(tmp_path / "12")
    with pytest.raises(ValueError, match="not a checkpoint"):
        tckpt.latest_step(str(tmp_path))
    (tmp_path / "12" / tckpt.STATE_FILE).write_bytes(b"")
    torch.save({"format": "something else"}, str(tmp_path / "12" / tckpt.STATE_FILE))
    with pytest.raises(ValueError, match="is not a"):
        tckpt.restore_state(str(tmp_path), {})


def test_geometry_mismatch_raises(tmp_path):
    _, _, state, _ = _trained_state(config=UpscalerConfig(features=16, depth=2))
    ckpt = str(tmp_path / "ckpt")
    tckpt.save_state(ckpt, 3, state.model.state_dict(), state.optimizer.state_dict())
    for other in (UpscalerConfig(features=8, depth=2),
                  UpscalerConfig(features=16, depth=3),
                  UpscalerConfig(features=16, depth=2, scale=3),
                  UpscalerConfig(features=16, depth=2, param_dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="geometry"):
            FrameUpscaler(other, device="cpu", checkpoint_dir=ckpt)


def test_optimizer_state_moves_between_implementations(tmp_path):
    """A state saved by the fused Adam (the card's, whose step count is a
    tensor beside its params) restores into the CPU's default Adam and
    back; each optimizer keeps its own implementation and learning rate,
    as optax's state holds only the moments and the count."""
    train_step, init_state = make_train_step(TINY, learning_rate=2e-3,
                                             device="cpu")
    fused = init_state(0)
    fused.optimizer = torch.optim.Adam(fused.model.parameters(), lr=2e-3,
                                       fused=True)
    low, high = map(torch.from_numpy, _batch(2, 8, 8, 2, seed=9))
    for _ in range(2):
        train_step(fused, low, high)
    ckpt = str(tmp_path / "ckpt")
    tckpt.save_state(ckpt, 2, fused.model.state_dict(), fused.optimizer.state_dict())

    plain = init_state(1)
    plain.optimizer = make_optimizer(plain.model, learning_rate=5e-4)
    _, params, opt_state = tckpt.restore_state(ckpt, plain.model.state_dict())
    plain.model.load_state_dict(params)
    tckpt.load_optimizer_state(plain.optimizer, opt_state)
    group = plain.optimizer.param_groups[0]
    assert group["lr"] == 5e-4 and not group["fused"]
    saved = fused.optimizer.state_dict()["state"]
    for i, st in plain.optimizer.state_dict()["state"].items():
        assert float(st["step"]) == 2.0
        assert torch.equal(st["exp_avg"], saved[i]["exp_avg"])
        assert torch.equal(st["exp_avg_sq"], saved[i]["exp_avg_sq"])
    assert np.isfinite(float(train_step(plain, low, high)))
    assert float(plain.optimizer.state_dict()["state"][0]["step"]) == 3.0
