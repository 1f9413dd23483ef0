"""The port's multi-controller path in gloo process groups on the CPU —
mirrors ``tests/test_multichip.py`` (one train step on several mesh
shapes), ``tests/test_multihost.py`` (inference across processes),
``tests/test_compute.py:75-215`` (the mesh step against one device,
restore onto a mesh, the entry points) and
``tests/test_trainer.py:69`` (``train()`` on a mesh).

Each group is ``parallel.group.run_group``: at most 4 spawned workers of
one CPU thread, the store on port 0, collectives timing out after 60 s,
workers killed when the group fails or outlives its time.  Workers
unpickle this module's top-level functions, so it imports JAX and the
JAX package only inside the tests that compare with them.
"""

import io
import math

import numpy as np
import pytest
import torch

from downloader_tpu_torch.compute import checkpoint as tckpt
from downloader_tpu_torch.compute import trainer as ttrainer
from downloader_tpu_torch.compute.infer import make_infer_fn
from downloader_tpu_torch.compute.models.upscaler import Upscaler, UpscalerConfig
from downloader_tpu_torch.compute.parallel.group import run_group
from downloader_tpu_torch.compute.parallel.mesh import (
    gather_global,
    make_mesh,
    shard_batch,
    shard_params,
)
from downloader_tpu_torch.compute.train import compile_train_step, make_train_step
from downloader_tpu_torch.compute.video import Y4MHeader, Y4MWriter

# features divide by the widest model axis (4)
TINY = UpscalerConfig(features=16, depth=2, scale=2)
GROUP_TIMEOUT = 120.0
# the mesh step against the port's one-device step: the same convs per
# rank and a data-mean of per-rank gradients (bf16 partial sums)
LOSS_RTOL, LEAF_RTOL, LEAF_ATOL = 1e-4, 5e-3, 1e-5
# against the JAX one-device step: the reference's own bound for its
# mesh step (tests/test_compute.py)
JAX_LOSS_RTOL = 2e-2


def _whole(plan, state) -> dict:
    """Every param of a rank's sharded model, gathered whole, as numpy
    (copies: a replicated param's whole is the live tensor)."""
    return {n: gather_global(plan, p.detach(), plan.param_spec(n, p)).numpy().copy()
            for n, p in state.model.named_parameters()}


# ------------------------------------------------------------- workers

def _step_worker(log, model_axis, params, low, high):
    plan = make_mesh(model_axis=model_axis, device="cpu")
    step, init_state, used = compile_train_step(TINY, mesh=plan)
    state = init_state(0)
    state.model.load_state_dict(shard_params(plan, params))
    loss = float(step(state, *shard_batch(plan, (low, high))))
    return used.shape, loss, _whole(plan, state)


def _infer_worker(log, params, frames):
    plan = make_mesh(device="cpu")
    return plan.shape, make_infer_fn(TINY, mesh=plan)(params, frames).numpy()


def _reshape_worker(log, ckpt_a, ckpt_b, low, high):
    """Restore a one-device state onto 2x2, step, save from the mesh,
    restore onto 1x4: what each rank holds, gathered whole."""
    whole = Upscaler(TINY, seed=None).state_dict()
    plan = make_mesh(model_axis=2, device="cpu")
    step, init_state, _ = compile_train_step(TINY, mesh=plan)
    state = init_state(1)
    _, params, opt = tckpt.restore_state(ckpt_a, whole, plan=plan)
    state.model.load_state_dict(params)
    tckpt.load_optimizer_state(state.optimizer, opt)
    restored_a = _whole(plan, state)
    step(state, *shard_batch(plan, (low, high)))
    saved = tckpt.save_state(ckpt_b, 1, state.model.state_dict(),
                             state.optimizer.state_dict(), plan=plan)
    wide = make_mesh(model_axis=4, device="cpu")
    _, params, opt = tckpt.restore_state(ckpt_b, whole, plan=wide)
    moments = {n: [gather_global(wide, t, wide.param_spec(n, t)).numpy()
                   for t in (opt["state"][i]["exp_avg"], opt["state"][i]["exp_avg_sq"])]
               for i, n in enumerate(whole)}
    return (restored_a, saved, {n: gather_global(wide, t, wide.param_spec(n, t)).numpy()
                                for n, t in params.items()}, moments,
            {n: tuple(t.shape) for n, t in params.items()})


def _failing_worker(log, bad_rank):
    import torch.distributed as dist

    log(f"rank {dist.get_rank()} up")
    if dist.get_rank() == bad_rank:
        raise ValueError("rank gave up")
    dist.barrier()  # waits for the failed rank until the group is killed
    return "unreachable"


# --------------------------------------------------------------- inputs

@pytest.fixture(scope="module")
def step_inputs():
    """Seeded params (the port's init) and a batch, as numpy."""
    params = {k: v.numpy() for k, v in Upscaler(TINY, seed=7).state_dict().items()}
    rng = np.random.default_rng(7)
    low = rng.random((8, 8, 8, 3), dtype=np.float32)
    high = np.repeat(np.repeat(low, 2, axis=1), 2, axis=2)
    return params, low, high


def _one_device_step(params, low, high):
    step, init_state = make_train_step(TINY, device="cpu")
    state = init_state(0)
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    loss = float(step(state, torch.from_numpy(low), torch.from_numpy(high)))
    return loss, {n: p.detach().numpy() for n, p in state.model.named_parameters()}


def _jax_one_device_loss(params, low, high) -> float:
    import jax
    import jax.numpy as jnp
    import optax

    from downloader_tpu.compute.models.upscaler import UpscalerConfig as JaxConfig
    from downloader_tpu.compute.train import make_train_step as jax_train_step
    from downloader_tpu_torch.compute.weights import to_flax

    tree = to_flax({k: torch.from_numpy(v) for k, v in params.items()}, TINY)
    tree = jax.tree_util.tree_map(jnp.asarray, tree)
    train_step, _ = jax_train_step(JaxConfig(features=16, depth=2, scale=2))
    _, _, loss = jax.jit(train_step)(tree, optax.adam(1e-3).init(tree),
                                     jnp.asarray(low), jnp.asarray(high))
    return float(loss)


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize("model_axis,mesh", [
    (2, {"data": 2, "model": 2}),
    (1, {"data": 4, "model": 1}),
    (4, {"data": 1, "model": 4}),
], ids=["2x2", "4x1", "1x4"])
def test_train_step_on_a_mesh_matches_one_device(step_inputs, model_axis, mesh):
    """One (data x model) step in a 4-rank group: every rank reads the
    same loss, within LOSS_RTOL of the port's one-device step and
    JAX_LOSS_RTOL of the JAX one-device step on the same weights; every
    updated param within LEAF_RTOL/LEAF_ATOL of the one-device step's."""
    params, low, high = step_inputs
    results = run_group(_step_worker, 4, "cpu",
                        args=(model_axis, params, low, high),
                        timeout=GROUP_TIMEOUT)
    shape, loss, leaves = results[0]
    assert shape == mesh
    assert len({r[1] for r in results}) == 1  # the same loss on every rank
    want_loss, want_leaves = _one_device_step(params, low, high)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(loss, _jax_one_device_loss(params, low, high),
                               rtol=JAX_LOSS_RTOL)
    assert sorted(leaves) == sorted(want_leaves)
    for name, leaf in leaves.items():
        np.testing.assert_allclose(leaf, want_leaves[name], rtol=LEAF_RTOL,
                                   atol=LEAF_ATOL, err_msg=name)


def test_two_process_inference_is_byte_identical():
    """``infer`` on a plan of two processes (each keeps its rows of the
    batch, the rows all-gathered back; n = 5: the pad path) is byte for
    byte the one-device output on both ranks."""
    params = {k: v for k, v in Upscaler(TINY, seed=3).state_dict().items()}
    frames = np.random.default_rng(8).integers(0, 256, (5, 8, 12, 3), np.uint8)
    want = make_infer_fn(TINY, "cpu")(params, frames).numpy()
    results = run_group(_infer_worker, 2, "cpu", args=(params, frames),
                        timeout=GROUP_TIMEOUT)
    for shape, got in results:
        assert shape == {"data": 2, "model": 1}
        np.testing.assert_array_equal(got, want)


def test_checkpoints_move_between_mesh_shapes_exactly(step_inputs, tmp_path):
    """A one-device checkpoint restores onto a 2x2 mesh, and a state saved
    from 2x2 restores onto 1x4 and onto one device, each bit for bit."""
    _, low, high = step_inputs
    step, init_state = make_train_step(TINY, device="cpu")
    state = init_state(5)
    step(state, torch.from_numpy(low), torch.from_numpy(high))
    ckpt_a, ckpt_b = str(tmp_path / "a"), str(tmp_path / "b")
    assert tckpt.save_state(ckpt_a, 1, state.model.state_dict(),
                            state.optimizer.state_dict())
    (restored_a, saved, restored_b, moments, shapes), *_ = run_group(
        _reshape_worker, 4, "cpu", args=(ckpt_a, ckpt_b, low, high),
        timeout=GROUP_TIMEOUT)
    for name, value in state.model.state_dict().items():
        np.testing.assert_array_equal(restored_a[name], value.numpy())
    assert saved is True
    whole = Upscaler(TINY, seed=None).state_dict()
    _, params, opt = tckpt.restore_state(ckpt_b, whole)  # on one device
    for i, name in enumerate(whole):
        assert tuple(params[name].shape) == tuple(whole[name].shape)
        np.testing.assert_array_equal(restored_b[name], params[name].numpy())
        np.testing.assert_array_equal(moments[name][0],
                                      opt["state"][i]["exp_avg"].numpy())
        np.testing.assert_array_equal(moments[name][1],
                                      opt["state"][i]["exp_avg_sq"].numpy())
    # each rank of 1x4 holds a quarter of every trunk conv's channels
    assert shapes["stem.weight"] == (4, 3, 5, 5)
    assert shapes["body_0.bias"] == (4,)
    assert shapes["subpixel.weight"] == (12, 16, 3, 3)


def _y4m(width, height, frames, seed) -> bytes:
    hdr = Y4MHeader(width=width, height=height)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    buf = io.BytesIO()
    writer = Y4MWriter(buf, hdr)
    for i in range(frames):
        y = np.clip(xx * 255 // width + yy * 3 + 7 * i
                    + rng.integers(-20, 21, (height, width)), 0, 255)
        writer.write_frame(y.astype(np.uint8),
                           rng.integers(64, 192, (height // 2, width // 2), np.uint8),
                           rng.integers(64, 192, (height // 2, width // 2), np.uint8))
    return buf.getvalue()


# train() on a mesh against train() on one device, step by step: the
# steps agree to LOSS_RTOL/LEAF_RTOL one at a time (above), and six steps
# of Adam carry the difference forward
TRAJECTORY_RTOL = 1e-2


def test_train_on_a_mesh_reduces_the_loss_and_resumes_on_one_device(tmp_path):
    """Mirrors ``test_train_reduces_loss_on_mesh`` (its learning rate
    3e-3) at the width of this file's other groups: 4 ranks at model
    axis 2 are a (2 x 2) mesh, batch 3 rounds up to the data axis's 4,
    rank 0 alone logs, the loss falls and follows the one-device loop's
    at batch 4 step by step; the mesh's checkpoint then resumes on one
    device."""
    media = tmp_path / "media"
    media.mkdir()
    (media / "a.y4m").write_bytes(_y4m(64, 48, frames=3, seed=1))
    (media / "b.y4m").write_bytes(_y4m(80, 64, frames=2, seed=2))
    paths = ttrainer.discover_media(str(media))
    ckpt = tmp_path / "ckpt"
    lines = []
    geometry = {"features": TINY.features, "depth": TINY.depth}
    settings = ttrainer.TrainerSettings(steps=6, batch=3, crop=32, log_every=1,
                                        learning_rate=3e-3, model_axis=2,
                                        checkpoint_dir=str(ckpt), **geometry)
    summary = ttrainer.train_in_group(paths, settings, 4, "cpu", log=lines.append)
    assert summary["devices"] == 4
    assert summary["mesh"] == {"data": 2, "model": 2}
    assert summary["batch"] == 4
    assert math.isfinite(summary["final_loss"])
    losses = [float(line.split()[3]) for line in lines if line.startswith("step ")]
    assert len(losses) == 6  # one rank logs
    assert losses[-1] < losses[0]
    assert lines[-1] == "checkpoint saved at step 6"
    single = []
    ttrainer.train(paths, ttrainer.TrainerSettings(
        steps=6, batch=4, crop=32, log_every=1, learning_rate=3e-3, **geometry),
        log=single.append, device="cpu")
    np.testing.assert_allclose(
        losses, [float(line.split()[3]) for line in single], rtol=TRAJECTORY_RTOL)
    resumed = []
    again = ttrainer.train(paths, ttrainer.TrainerSettings(
        steps=1, batch=3, crop=32, checkpoint_dir=str(ckpt), **geometry),
        log=resumed.append, device="cpu")
    assert "resumed from step 6" in resumed and again["final_step"] == 7


def test_dryrun_multichip_on_the_cpu(capsys):
    """The multi-device dry run, in 4 gloo processes: a (2 x 2) step, then a
    save -> restore onto (1 x 4) and a step there, then the engine over
    4 listings of the CPU; it prints the reference's ok line."""
    from downloader_tpu_torch.graft_entry import dryrun_multichip

    line = dryrun_multichip(4, device="cpu")
    assert capsys.readouterr().out.strip() == line
    assert line.startswith("dryrun_multichip ok: mesh={'data': 2, 'model': 2} loss=")
    assert "infer_checksum=" in line
    assert "reshaped_mesh={'data': 1, 'model': 4} reshaped_loss=" in line


def test_entry_contract_and_the_card_count(monkeypatch):
    """``entry()`` gives the forward and its args ((8, 64, 64, 3) in,
    (8, 128, 128, 3) out, as the reference's); a dry run on CUDA with
    fewer cards than asked raises, naming the count."""
    from downloader_tpu_torch.graft_entry import dryrun_multichip, entry

    fn, args = entry(device="cpu")
    with torch.inference_mode():
        out = fn(*args)
    assert tuple(args[1].shape) == (8, 64, 64, 3)
    assert tuple(out.shape) == (8, 128, 128, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        dryrun_multichip(2)


def test_a_failing_rank_fails_the_group_with_its_traceback():
    """A rank that raises ends the group at once: its peer, blocked in a
    collective, is killed, and the error names the rank and its cause."""
    lines = []
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        run_group(_failing_worker, 2, "cpu", args=(1,), timeout=GROUP_TIMEOUT,
                  log=lines.append)
    assert "ValueError: rank gave up" in str(err.value)
    assert sorted(lines) == ["rank 0 up", "rank 1 up"]
