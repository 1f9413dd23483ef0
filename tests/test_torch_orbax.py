"""The port's reader of the JAX package's orbax checkpoints
(``downloader_tpu_torch/compute/orbax_reader/``), held against
``zstandard``, tensorstore and orbax, and the entry points that take a
checkpoint directory (``restore_state``, ``FrameUpscaler``, ``train()``,
``restore_state(plan=)``, the service's ``upscale`` stage) held against
the JAX package on the same step.

Everything is small (``features=16, depth=2``) but the committed fixture,
a step of ``UpscalerConfig()`` at full width.  JAX, orbax, tensorstore
and ``zstandard`` are imported inside the tests: the process-group
workers unpickle this module by name.

Write the committed fixture again, from the repository's root (JAX on
the CPU; the port's package never imports the JAX package):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_orbax.py
"""

import asyncio
import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from downloader_tpu_torch.compute import checkpoint as tckpt
from downloader_tpu_torch.compute.models.upscaler import Upscaler, UpscalerConfig
from downloader_tpu_torch.compute.orbax_reader import zstd
from downloader_tpu_torch.compute.orbax_reader.ocdbt import OcdbtStore
from downloader_tpu_torch.compute.orbax_reader.step import read_step
from downloader_tpu_torch.compute.parallel.group import run_group
from downloader_tpu_torch.compute.parallel.mesh import gather_global, make_mesh
from downloader_tpu_torch.compute.pipeline import FrameUpscaler
from downloader_tpu_torch.compute.video import Y4MHeader, Y4MReader, Y4MWriter
from downloader_tpu_torch.compute.weights import adam_from_optax, from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "downloader_tpu_torch", "compute", "orbax_reader",
                       "testdata")
TINY = UpscalerConfig(features=16, depth=2)
# the train step's bf16 bound against the JAX losses (tests/test_torch_train.py)
LOSS_RTOL = 1e-3


# -- zstd -----------------------------------------------------------------

def _payloads():
    rng = np.random.default_rng(7)
    weights = (0.02 * rng.standard_normal(64 * 1024)).astype(np.float32)
    return {
        "empty": b"",
        "random": rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
        "repetitive": (b"orbax ocdbt zarr " * 16000)[:256 * 1024],
        "f32": weights.tobytes(),
        "skewed": rng.choice(np.arange(6, dtype=np.uint8), 100_000,
                             p=[.55, .2, .1, .08, .05, .02]).tobytes(),
    }


@pytest.mark.parametrize("content_size", [False, True])
@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [-5, 1, 3, 19])
def test_zstd_round_trips_zstandard(level, checksum, content_size):
    import zstandard

    comp = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size)
    for name, data in _payloads().items():
        assert zstd.decompress(comp.compress(data)) == data, name


@settings(max_examples=50, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(pieces=st.lists(st.binary(max_size=300), max_size=12),
       repeats=st.integers(1, 40), level=st.sampled_from([-3, 1, 5, 12]))
def test_zstd_round_trips_generated_data(pieces, repeats, level):
    import zstandard

    data = b"".join(p * (1 + i % repeats) for i, p in enumerate(pieces)) * 3
    frame = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data)
    assert zstd.decompress(frame) == data


def test_zstd_skippable_and_concatenated_frames():
    import zstandard

    comp = zstandard.ZstdCompressor(level=3)
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    assert zstd.decompress(comp.compress(b"a" * 500) + skip
                           + comp.compress(b"xyz")) == b"a" * 500 + b"xyz"
    # a frame without a content size, decoded through a stream writer
    out = zstandard.ZstdCompressor(level=1).compressobj()
    data = _payloads()["f32"]
    frame = out.compress(data) + out.flush()
    assert zstd.decompress(frame) == data


def test_zstd_malformed_frames_raise():
    import zstandard

    data = _payloads()["f32"][:20000] + b"abc" * 3000
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    cases = {
        "empty": b"",
        "bad magic": b"\x00" + frame[1:],
        "truncated header": frame[:5],
        "truncated block": frame[:len(frame) // 2],
        "no checksum": frame[:-4],
        "bad checksum": frame[:-1] + bytes([frame[-1] ^ 1]),
        "reserved bit": frame[:4] + bytes([frame[4] | 0x08]) + frame[5:],
        "dictionary": zstandard.ZstdCompressor(
            dict_data=zstandard.ZstdCompressionDict(b"some dictionary " * 64),
            write_dict_id=True).compress(b"some dictionary text" * 20),
        "trailing garbage": frame + b"\x01\x02",
    }
    for name, bad in cases.items():
        with pytest.raises(ValueError):
            zstd.decompress(bad)
            pytest.fail(name)


@settings(max_examples=50, deadline=None)
@given(position=st.integers(0, 10**6), flip=st.integers(1, 255))
def test_zstd_corrupted_frame_raises_value_error_or_decodes(position, flip):
    """Any corrupted byte gives ``ValueError`` or, where the frame still
    parses, the checksum's verdict: never another exception, never a
    hang."""
    import zstandard

    data = _payloads()["skewed"][:20000] + _payloads()["repetitive"][:20000]
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True)
                      .compress(data))
    frame[position % len(frame)] ^= flip
    try:
        out = zstd.decompress(bytes(frame))
    except ValueError:
        return
    assert out == data


# -- JAX steps written by the JAX package ---------------------------------

def _flax_tree(config, seed=0):
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


def _jax_state(features=16, depth=2, steps=2):
    """A JAX train state with non-zero moments: ``steps`` Adam steps from
    a numpy-drawn tree on a seeded batch."""
    import jax
    import jax.numpy as jnp
    import optax

    from downloader_tpu.compute.models.upscaler import UpscalerConfig as JaxConfig
    from downloader_tpu.compute.train import make_train_step

    config = JaxConfig(features=features, depth=depth)
    step, _ = make_train_step(config)
    params = jax.tree_util.tree_map(jnp.asarray, _flax_tree(config))
    opt = optax.adam(1e-3).init(params)
    rng = np.random.default_rng(3)
    low = rng.uniform(0, 1, (2, 12, 12, 3)).astype(np.float32)
    high = rng.uniform(0, 1, (2, 24, 24, 3)).astype(np.float32)
    fn = jax.jit(step)
    for _ in range(steps):
        params, opt, _loss = fn(params, opt, low, high)
    return params, opt


def _numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """One JAX state saved twice by the JAX package's ``save_state``: from
    one device, and sharded over a (data 2 x model 4) mesh of the 8 host
    devices, whose trunk kernels and biases are written in several chunks."""
    from downloader_tpu.compute import checkpoint as jckpt
    from downloader_tpu.compute.parallel import make_mesh as jax_make_mesh
    from downloader_tpu.compute.parallel import shard_params

    root = tmp_path_factory.mktemp("jax_steps")
    params, opt = _jax_state()
    single, mesh = str(root / "single"), str(root / "mesh")
    jckpt.save_state(single, 2, params, opt)
    plan = jax_make_mesh(8, model_axis=4)
    jckpt.save_state(mesh, 2, shard_params(plan, params), shard_params(plan, opt))
    return {"single": single, "mesh": mesh, "params": _numpy(params),
            "opt": _numpy(opt)}


def _tensorstore_items(item_dir):
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{item_dir}"}).result()
    keys = sorted(k.decode() for k in kv.list().result())
    return {k: kv.read(k).result().value for k in keys}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, prefix + (key,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("item", ["params", "opt_state"])
@pytest.mark.parametrize("layout", ["single", "mesh"])
def test_ocdbt_keys_and_bytes_match_tensorstore(jax_steps, layout, item):
    item_dir = os.path.join(jax_steps[layout], "2", item)
    store = OcdbtStore(item_dir)
    want = _tensorstore_items(item_dir)
    assert store.list() == list(want)
    for key, value in want.items():
        assert store.read(key) == value, key


@pytest.mark.parametrize("compression", [None, {"id": "zstd", "level": 5}])
def test_ocdbt_interior_nodes_match_tensorstore(tmp_path, compression):
    """A store of many keys in small nodes (a b-tree of several levels,
    values inline and in data files) written by tensorstore itself."""
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": {"compression": compression,
                                     "max_decoded_node_bytes": 256,
                                     "max_inline_value_bytes": 24}}).result()
    rng = np.random.default_rng(1)
    for i in rng.permutation(90):
        kv.write(f"array.{i % 7}/{i:03d}.0", bytes([i % 251]) * int(i * 3 % 70)).result()
    kv.delete_range(ts.KvStore.KeyRange("array.3/", "array.3/050")).result()
    want = _tensorstore_items(str(tmp_path))
    store = OcdbtStore(str(tmp_path))
    assert store.list() == list(want)
    assert all(store.read(k) == v for k, v in want.items())


@pytest.mark.parametrize("layout", ["single", "mesh"])
def test_read_step_matches_orbax_restore(jax_steps, layout):
    from downloader_tpu.compute import checkpoint as jckpt

    tree = read_step(os.path.join(jax_steps[layout], "2"))
    step, params, opt = jckpt.restore_state(jax_steps[layout], jax_steps["params"],
                                            jax_steps["opt"])
    assert step == 2
    got = dict(_leaves(tree["params"]))
    want = {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in _flat(params)}
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == np.asarray(value).dtype
        assert got[key].tobytes() == np.asarray(value).tobytes(), key
    adam = opt[0]
    assert tree["opt_state"]["1"] is None
    assert int(tree["opt_state"]["0"]["count"]) == int(adam.count) == 2
    for moment in ("mu", "nu"):
        for path, leaf in _flat(getattr(adam, moment)):
            keys = tuple(str(k.key) for k in path)
            got_leaf = tree["opt_state"]["0"][moment]
            for key in keys:
                got_leaf = got_leaf[key]
            assert got_leaf.tobytes() == np.asarray(leaf).tobytes(), (moment, keys)


def _flat(tree):
    import jax

    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_mesh_save_reads_as_one_device_save(jax_steps):
    """The mesh's save holds each trunk kernel in several chunks along
    its output channels; assembled, every array equals the one-device
    save's."""
    kernel = "params.stem.kernel/.zarray"
    single = json.loads(OcdbtStore(os.path.join(jax_steps["single"], "2", "params"))
                        .read(kernel))
    mesh = json.loads(OcdbtStore(os.path.join(jax_steps["mesh"], "2", "params"))
                      .read(kernel))
    assert single["chunks"] == [5, 5, 3, 16]
    assert mesh["chunks"][:3] == [5, 5, 3] and 16 % mesh["chunks"][3] == 0 < 16 - mesh["chunks"][3]
    a = read_step(os.path.join(jax_steps["single"], "2"))
    b = read_step(os.path.join(jax_steps["mesh"], "2"))
    for item in ("params", "opt_state"):
        left, right = dict(_leaves(a[item])), dict(_leaves(b[item]))
        assert set(left) == set(right)
        for key, value in left.items():
            if value is None:
                assert right[key] is None
            else:
                assert value.tobytes() == right[key].tobytes(), key


def test_zarr_fill_chunks_and_bfloat16_match_tensorstore(tmp_path):
    """A bfloat16 array in ragged chunks of which some were never
    written reads as tensorstore reads it (a missing chunk holds the fill
    value), widened exactly to float32."""
    import tensorstore as ts

    from downloader_tpu_torch.compute.orbax_reader.zarr2 import read_array

    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                          "base": f"file://{tmp_path}", "path": "w/"},
            "metadata": {"compressor": {"id": "zstd", "level": 1}, "dtype": "bfloat16",
                         "shape": [5, 7], "chunks": [2, 3], "fill_value": 1.5}}
    arr = ts.open(spec, create=True).result()
    values = np.arange(35, dtype=np.float32).reshape(5, 7) / 8 - 2
    arr[1:5, 0:3].write(values[1:5, 0:3].astype(arr.dtype.numpy_dtype)).result()
    arr[4:5, 6:7].write(values[4:5, 6:7].astype(arr.dtype.numpy_dtype)).result()
    want = arr.read().result().astype(np.float32)
    got = read_array(OcdbtStore(str(tmp_path)), "w")
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert got[0, 3] == 1.5 and got[4, 6] == values[4, 6]


def test_zarr_rejects_other_compressors(tmp_path):
    import tensorstore as ts

    from downloader_tpu_torch.compute.orbax_reader.zarr2 import read_array

    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                          "base": f"file://{tmp_path}", "path": "b/"},
            "metadata": {"compressor": {"id": "blosc"}, "dtype": "<f4",
                         "shape": [4], "chunks": [4]}}
    ts.open(spec, create=True).result().write(np.ones(4, np.float32)).result()
    with pytest.raises(ValueError, match="blosc"):
        read_array(OcdbtStore(str(tmp_path)), "b")


# -- the checkpoint module and the entry points ---------------------------

def test_restore_state_from_a_jax_step_equals_the_bridge(jax_steps):
    """``restore_state`` on the JAX package's step gives what
    ``from_flax`` and ``adam_from_optax`` make of the JAX state: the
    same tensors bit for bit, ``step`` = optax's ``count``."""
    like = Upscaler(TINY, seed=None).state_dict()
    for layout in ("single", "mesh"):
        step, params, opt = tckpt.restore_state(jax_steps[layout], like)
        assert step == 2
        want = from_flax(jax_steps["params"], TINY)
        assert list(params) == list(want) == list(like)
        assert all(torch.equal(params[k], want[k]) for k in want)
        adam = jax_steps["opt"][0]
        want_opt = adam_from_optax({"0": {"count": adam.count, "mu": adam.mu,
                                          "nu": adam.nu}, "1": None}, TINY)
        assert opt["param_groups"] == want_opt["param_groups"]
        for i, entry in want_opt["state"].items():
            assert float(opt["state"][i]["step"]) == float(entry["step"]) == 2.0
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(opt["state"][i][key], entry[key]), (i, key)


def test_adam_from_optax_continues_the_jax_run(jax_steps):
    """One more step on each side from the restored state: the port's
    Adam on ``adam_from_optax``'s state against optax on the saved one,
    within the train step's bound."""
    import jax

    from downloader_tpu.compute.models.upscaler import UpscalerConfig as JaxConfig
    from downloader_tpu.compute.train import make_train_step as jax_step
    from downloader_tpu_torch.compute.train import make_train_step

    rng = np.random.default_rng(11)
    low = rng.uniform(0, 1, (2, 12, 12, 3)).astype(np.float32)
    high = rng.uniform(0, 1, (2, 24, 24, 3)).astype(np.float32)
    step, _ = jax_step(JaxConfig(features=16, depth=2))
    params, opt, _ = jax.jit(step)(jax_steps["params"], jax_steps["opt"], low, high)
    want_loss = float(jax.jit(step)(params, opt, low, high)[2])

    train_step, init_state = make_train_step(TINY, device="cpu")
    state = init_state(seed=1)
    _, restored, opt_state = tckpt.restore_state(jax_steps["single"],
                                                 state.model.state_dict())
    state.model.load_state_dict(restored)
    tckpt.load_optimizer_state(state.optimizer, opt_state)
    train_step(state, torch.from_numpy(low), torch.from_numpy(high))
    got_loss = float(train_step(state, torch.from_numpy(low), torch.from_numpy(high)))
    assert abs(got_loss - want_loss) / want_loss < LOSS_RTOL, (got_loss, want_loss)


def _planes(frames):
    return [np.stack([f[i] for f in frames]) for i in range(3)]


def _clip(width, height, frames, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    out = []
    for i in range(frames):
        y = np.clip((xx * 255 // width + yy * 64 // height + 9 * i) % 256
                    + rng.integers(-24, 25, (height, width)), 0, 255)
        out.append((y.astype(np.uint8),
                    rng.integers(64, 192, (height // 2, width // 2)).astype(np.uint8),
                    rng.integers(64, 192, (height // 2, width // 2)).astype(np.uint8)))
    return out


def _assert_within(got, want, max_step, min_exact):
    for g, w in zip(got, want):
        diff = np.abs(np.asarray(g).astype(np.int16) - np.asarray(w).astype(np.int16))
        assert diff.max() <= max_step, diff.max()
        assert (diff == 0).mean() > min_exact, (diff == 0).mean()


def test_engine_from_a_jax_checkpoint_matches_the_jax_engine(jax_steps):
    """``FrameUpscaler(checkpoint_dir=<JAX dir>)`` on the CPU against the
    JAX engine restored from the same directory: the reference's bound,
    <= 1 u8 step and > 97% exact."""
    from downloader_tpu.compute.models.upscaler import UpscalerConfig as JaxConfig
    from downloader_tpu.compute.pipeline import FrameUpscaler as JaxUpscaler

    planes = _planes(_clip(48, 32, 2, seed=4))
    got = FrameUpscaler(TINY, device="cpu", batch=2,
                        checkpoint_dir=jax_steps["single"]).upscale_batch(*planes, 2, 2)
    want = JaxUpscaler(JaxConfig(features=16, depth=2), batch=2,
                       checkpoint_dir=jax_steps["single"]).upscale_batch(*planes, 2, 2)
    seeded = FrameUpscaler(TINY, device="cpu", batch=2).upscale_batch(*planes, 2, 2)
    assert any((np.asarray(a) != np.asarray(b)).any() for a, b in zip(got, seeded))
    _assert_within(got, want, 1, 0.97)


def _write_clip(path, width, height, frames, seed):
    with open(path, "wb") as fh:
        writer = Y4MWriter(fh, Y4MHeader(width=width, height=height,
                                         colorspace="420jpeg"))
        for planes in _clip(width, height, frames, seed):
            writer.write_frame(*planes)


def _losses(lines):
    return {int(line.split()[1]): float(line.split()[3])
            for line in lines if line.startswith("step ")}


def test_port_trainer_resumes_a_jax_run(tmp_path):
    """3 steps of the JAX package's ``train()``, then 3 of the port's
    resumed from its orbax directory, against the same JAX run resumed by
    the JAX package (both loops restart their crop stream on resume):
    the losses within the train step's bound, and the directory keeps
    the orbax steps beside the port's step 6."""
    from downloader_tpu.compute import trainer as jtrainer
    from downloader_tpu_torch.compute import trainer as ttrainer

    media = tmp_path / "media"
    media.mkdir()
    _write_clip(media / "a.y4m", 64, 48, 3, seed=1)
    paths = [str(media / "a.y4m")]
    settings_ = dict(steps=3, batch=8, crop=32, log_every=1, features=16,
                     depth=2, learning_rate=1e-3, seed=3)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jtrainer.train(paths, jtrainer.TrainerSettings(checkpoint_dir=str(jax_dir),
                                                   **settings_))
    shutil.copytree(jax_dir, port_dir)
    jlines, tlines = [], []
    jtrainer.train(paths, jtrainer.TrainerSettings(checkpoint_dir=str(jax_dir),
                                                   **settings_), log=jlines.append)
    summary = ttrainer.train(paths, ttrainer.TrainerSettings(
        checkpoint_dir=str(port_dir), **settings_), log=tlines.append, device="cpu")
    assert jlines[0] == tlines[0] == "resumed from step 3"
    want, got = _losses(jlines), _losses(tlines)
    assert list(got) == list(want) == [4, 5, 6]
    assert all(abs(got[s] - want[s]) / want[s] < LOSS_RTOL for s in want), (got, want)
    assert summary["final_step"] == 6
    assert sorted(os.listdir(port_dir), key=int) == ["3", "6"]
    assert os.path.isdir(port_dir / "3" / "params")
    assert os.path.isfile(port_dir / "6" / tckpt.STATE_FILE)


def _plan_worker(log, ckpt):
    """Restore a JAX step onto a (data 1 x model 2) mesh; each rank's
    params and moments, gathered whole, and their local shapes."""
    whole = Upscaler(TINY, seed=None).state_dict()
    plan = make_mesh(model_axis=2, device="cpu")
    step, params, opt = tckpt.restore_state(ckpt, whole, plan=plan)
    gathered = {n: gather_global(plan, t, plan.param_spec(n, t)).numpy().copy()
                for n, t in params.items()}
    moments = {n: gather_global(plan, opt["state"][i]["exp_avg"],
                                plan.param_spec(n, opt["state"][i]["exp_avg"])).numpy()
               for i, n in enumerate(whole)}
    return step, gathered, moments, {n: tuple(t.shape) for n, t in params.items()}


def test_restore_state_with_a_plan_from_a_jax_step(jax_steps):
    """``restore_state(plan=)`` on the JAX package's step in a 2-rank
    gloo group: each rank holds its block of the bridged state."""
    results = run_group(_plan_worker, 2, "cpu", args=(jax_steps["mesh"],),
                        timeout=180)
    want = from_flax(jax_steps["params"], TINY)
    want_mu = from_flax(jax_steps["opt"][0].mu, TINY)
    for step, gathered, moments, shapes in results:
        assert step == 2
        for name, value in want.items():
            assert np.array_equal(gathered[name], value.numpy()), name
            assert np.array_equal(moments[name], want_mu[name].numpy()), name
        assert shapes["stem.weight"] == (8, 3, 5, 5)


def test_service_stage_serves_a_jax_checkpoint(tmp_path):
    """The port's ``upscale`` stage with ``instance.upscale.checkpoint``
    naming the JAX package's directory stages what the port's engine
    restored from it makes of the clip, byte for byte."""
    from downloader_tpu_torch import schemas
    from downloader_tpu_torch.platform.config import ConfigNode
    from downloader_tpu_torch.platform.logging import NullLogger
    from downloader_tpu_torch.stages.base import Job, StageContext, load_stages
    from downloader_tpu_torch.utils import EventEmitter

    params, opt = _jax_state()
    from downloader_tpu.compute import checkpoint as jckpt

    ckpt = str(tmp_path / "jax")
    jckpt.save_state(ckpt, 5, params, opt)
    clip = tmp_path / "clip.y4m"
    _write_clip(clip, 32, 24, 3, seed=2)
    config = ConfigNode({"instance": {"download_path": str(tmp_path / "dl"),
                                      "upscale": {"enabled": True, "features": 16,
                                                  "depth": 2, "batch": 2,
                                                  "device": "cpu",
                                                  "checkpoint": ckpt}}})
    ctx = StageContext(config=config, emitter=EventEmitter(), logger=NullLogger())

    async def run():
        table = await load_stages(ctx, ["upscale"])
        job = Job(media=schemas.Media(id="jax", type=schemas.MediaType.Value("MOVIE")),
                  last_stage={"files": [str(clip)], "downloadPath": str(tmp_path)})
        return await table["upscale"](job)

    out = asyncio.run(run())
    staged = out["files"][0]
    assert staged.endswith("clip.2x.y4m")
    engine = FrameUpscaler(TINY, device="cpu", batch=2, checkpoint_dir=ckpt)
    with open(clip, "rb") as src:
        frames = list(Y4MReader(src))
    with open(staged, "rb") as fh:
        got = list(Y4MReader(fh))
    want = engine.upscale_batch(*_planes(frames), 2, 2)
    for i, plane in enumerate(want):
        assert np.array_equal(np.stack([f[i] for f in got]), np.asarray(plane)), i


def test_mixed_directory_counts_both_formats(jax_steps, tmp_path):
    """The port writes beside the JAX package's steps: a step at or below
    the latest of either format is not written, keep-last-3 counts both
    (the oldest orbax step goes, as on orbax's own continued run), and
    either format's step restores."""
    ckpt = str(tmp_path / "mixed")
    for step in (1, 2, 3):
        shutil.copytree(os.path.join(jax_steps["single"], "2"),
                        os.path.join(ckpt, str(step)))
    like = Upscaler(TINY, seed=None).state_dict()
    _, params, opt = tckpt.restore_state(ckpt, like)
    assert tckpt.latest_step(ckpt) == 3
    assert not tckpt.save_state(ckpt, 3, params, opt)
    assert not tckpt.save_state(ckpt, 2, params, opt)
    assert tckpt.save_state(ckpt, 4, params, opt)
    assert sorted(os.listdir(ckpt), key=int) == ["2", "3", "4"]
    assert tckpt.latest_step(ckpt) == 4
    step, again, _ = tckpt.restore_state(ckpt, like)
    assert step == 4 and all(torch.equal(again[k], params[k]) for k in params)
    assert tckpt.restore_state(ckpt, like, step=2)[0] == 2


def test_unreadable_orbax_steps_raise_naming_the_format_and_file(jax_steps, tmp_path):
    """A missing manifest, a truncated data file, a bad zstd frame in a
    chunk and a missing item metadata file: each a ``ValueError`` naming
    orbax and the file, never an empty directory."""
    like = Upscaler(TINY, seed=None).state_dict()

    def broken(name, damage):
        ckpt = tmp_path / name
        shutil.copytree(jax_steps["single"], ckpt)
        target = damage(ckpt / "2")
        assert tckpt.latest_step(str(ckpt)) == 2
        with pytest.raises(ValueError, match="orbax") as err:
            tckpt.restore_state(str(ckpt), like)
        assert os.path.basename(target) in str(err.value), str(err.value)

    def no_manifest(step):
        os.remove(step / "params" / "manifest.ocdbt")
        return "manifest.ocdbt"

    def biggest(step):
        files = [os.path.join(d, f) for d, _, names in os.walk(step / "opt_state")
                 for f in names if os.sep + "d" + os.sep in os.path.join(d, f)]
        return max(files, key=os.path.getsize)

    def truncate(step):
        path = biggest(step)
        with open(path, "r+b") as fh:
            fh.truncate(os.path.getsize(path) // 2)
        return path

    def bad_frame(step):
        store = OcdbtStore(str(step / "params"))
        path, offset, _length = store._entries[b"params.stem.kernel/0.0.0.0"]
        full = os.path.join(step / "params", path)
        with open(full, "r+b") as fh:
            fh.seek(offset)
            fh.write(b"\x00\x00\x00\x00")
        return "params.stem.kernel"

    def no_metadata(step):
        os.remove(step / "opt_state" / "_METADATA")
        return "_METADATA"

    broken("manifest", no_manifest)
    broken("truncated", truncate)
    broken("frame", bad_frame)
    broken("metadata", no_metadata)


def test_committed_fixture_reads_as_tensorstore_reads_it():
    """The full-width step the chip run serves: the port's store lists and
    reads what tensorstore does, every array's sha256 is the manifest's,
    and the port's CPU engine restored from it stays within the bound the
    chip run holds the card to against that output, at a > 97% exact
    share: four bf16 layers of 128 features on trained weights move a few
    values by 2 steps (5 of 73,728 luma values, 99.83% exact, measured)."""
    with open(os.path.join(FIXTURE, "manifest.json")) as fh:
        manifest = json.load(fh)
    ckpt = os.path.join(FIXTURE, "ckpt")
    assert tckpt.latest_step(ckpt) == manifest["step"] == 3
    for item in ("params", "opt_state"):
        item_dir = os.path.join(ckpt, "3", item)
        want = _tensorstore_items(item_dir)
        store = OcdbtStore(item_dir)
        assert store.list() == list(want)
        assert all(store.read(k) == v for k, v in want.items())
    tree = read_step(os.path.join(ckpt, "3"))
    got = {"/".join((item,) + key): value for item in ("params", "opt_state")
           for key, value in _leaves(tree[item]) if value is not None}
    assert set(got) == set(manifest["arrays"])
    for name, value in got.items():
        entry = manifest["arrays"][name]
        assert [list(value.shape), str(value.dtype)] == [entry["shape"], entry["dtype"]]
        assert hashlib.sha256(value.tobytes()).hexdigest() == entry["sha256"], name
    for name, digest in manifest["files"].items():
        with open(os.path.join(FIXTURE, name), "rb") as fh:
            assert hashlib.sha256(fh.read()).hexdigest() == digest, name
    with open(os.path.join(FIXTURE, "clip.y4m"), "rb") as fh:
        frames = list(Y4MReader(fh))
    with open(os.path.join(FIXTURE, "clip.2x.y4m"), "rb") as fh:
        want = _planes(list(Y4MReader(fh)))
    engine = FrameUpscaler(device="cpu", batch=2, checkpoint_dir=ckpt)
    _assert_within(engine.upscale_batch(*_planes(frames), 2, 2), want, 3, 0.97)


_BLOCKED = r"""
import importlib.abc, sys
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard",
          "downloader_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BANNED):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
from downloader_tpu_torch.compute import checkpoint
from downloader_tpu_torch.compute.models.upscaler import Upscaler, UpscalerConfig
like = Upscaler(UpscalerConfig(features=16, depth=2), seed=None).state_dict()
step, params, opt = checkpoint.restore_state(sys.argv[1], like)
print("RESTORED", step, len(params), len(opt["state"]), float(opt["state"][0]["step"]))
print("LOADED", sorted(m for m in sys.modules
                       if any(m == b or m.startswith(b + ".") for b in BANNED)))
"""


def test_fresh_interpreter_without_jax_orbax_tensorstore_or_zstandard_restores(
        jax_steps):
    """The card machine's condition: with ``jax``, ``orbax``,
    ``tensorstore`` and ``zstandard`` (and the JAX package) blocked by a
    meta-path finder, the port restores the JAX package's step."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, jax_steps["mesh"]],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[-2] == "RESTORED 2 6 6 2.0", lines
    assert lines[-1] == "LOADED []", lines


# -- the committed fixture ------------------------------------------------

def _write_fixture(out: str) -> None:
    """A step of ``UpscalerConfig()`` after 3 JAX train steps from
    ``init_params(PRNGKey(0))`` on a seeded batch, written by the JAX
    package's ``save_state``; a seeded 2-frame 128x72 4:2:0 clip; the JAX
    package's CPU output for it from that step; and ``manifest.json``."""
    import jax
    import optax

    from downloader_tpu import cli as jcli
    from downloader_tpu.compute import checkpoint as jckpt
    from downloader_tpu.compute.models.upscaler import init_params
    from downloader_tpu.compute.train import make_train_step

    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    _, params = init_params(jax.random.PRNGKey(0))
    opt = optax.adam(1e-3).init(params)
    step, _ = make_train_step()
    rng = np.random.default_rng(0)
    low = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    high = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    fn = jax.jit(step)
    for _ in range(3):
        params, opt, _loss = fn(params, opt, low, high)
    ckpt = os.path.join(out, "ckpt")
    jckpt.save_state(ckpt, 3, params, opt)
    _write_clip(os.path.join(out, "clip.y4m"), 128, 72, 2, seed=16)
    assert jcli.main(["upscale", os.path.join(out, "clip.y4m"),
                      os.path.join(out, "clip.2x.y4m"), "--checkpoint-dir", ckpt]) == 0
    tree = read_step(os.path.join(ckpt, "3"))
    arrays = {"/".join((item,) + key): value for item in ("params", "opt_state")
              for key, value in _leaves(tree[item]) if value is not None}
    files = {}
    for name in ("clip.y4m", "clip.2x.y4m"):
        with open(os.path.join(out, name), "rb") as fh:
            files[name] = hashlib.sha256(fh.read()).hexdigest()
    with open(os.path.join(out, "manifest.json"), "w") as fh:
        json.dump({"step": 3, "arrays": {
            name: {"shape": list(v.shape), "dtype": str(v.dtype),
                   "sha256": hashlib.sha256(v.tobytes()).hexdigest()}
            for name, v in sorted(arrays.items())}, "files": files}, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    _write_fixture(FIXTURE)
