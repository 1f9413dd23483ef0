"""The port's training loop, its checkpoints reaching the engine, and
the ``train``/``upscale --checkpoint-dir`` CLI, on the CPU, held against
the JAX package's trainer (``downloader_tpu/compute/trainer.py``).

The JAX side sees 8 virtual CPU devices (``tests/conftest.py``), so its
``train()`` builds a (data 8 x model 1) mesh: the end-to-end comparison
runs at a batch of 8, which its data axis leaves as it is.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from downloader_tpu.compute import checkpoint as jckpt
from downloader_tpu.compute import trainer as jtrainer
from downloader_tpu.compute.models.upscaler import UpscalerConfig as JaxConfig
from downloader_tpu_torch.cli import main as cli_main
from downloader_tpu_torch.compute import checkpoint as tckpt
from downloader_tpu_torch.compute import trainer as ttrainer
from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
from downloader_tpu_torch.compute.pipeline import FrameUpscaler
from downloader_tpu_torch.compute.train import make_optimizer
from downloader_tpu_torch.compute.video import Y4MHeader, Y4MReader, Y4MWriter
from downloader_tpu_torch.compute.weights import from_flax, to_flax


def _y4m(width, height, frames, colorspace="420jpeg", seed=0) -> bytes:
    """A seeded Y4M stream: gradients plus noise."""
    hdr = Y4MHeader(width=width, height=height, colorspace=colorspace)
    ch, cw = hdr.chroma_shape
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    buf = io.BytesIO()
    writer = Y4MWriter(buf, hdr)
    for i in range(frames):
        y = np.clip(xx * 255 // width + yy * 3 + 7 * i
                    + rng.integers(-20, 21, (height, width)), 0, 255)
        writer.write_frame(y.astype(np.uint8),
                           rng.integers(64, 192, (ch, cw), np.uint8),
                           rng.integers(64, 192, (ch, cw), np.uint8))
    return buf.getvalue()


@pytest.fixture
def media_dir(tmp_path):
    d = tmp_path / "media"
    d.mkdir()
    (d / "a.y4m").write_bytes(_y4m(64, 48, frames=3, seed=1))
    (d / "b.y4m").write_bytes(_y4m(80, 64, frames=2, seed=2))
    return d


def _losses(lines):
    return {int(line.split()[1]): float(line.split()[3])
            for line in lines if line.startswith("step ")}


def test_discover_media(media_dir, tmp_path):
    paths = ttrainer.discover_media(str(media_dir))
    assert paths == jtrainer.discover_media(str(media_dir))
    assert [os.path.basename(p) for p in paths] == ["a.y4m", "b.y4m"]
    assert ttrainer.discover_media(str(media_dir / "a.y4m")) == [str(media_dir / "a.y4m")]
    with pytest.raises(FileNotFoundError):
        ttrainer.discover_media(str(tmp_path))


@pytest.mark.parametrize("colorspace", ["420jpeg", "444"])
def test_hr_crop_stream_is_byte_identical_to_reference(tmp_path, colorspace):
    """The same seed and media give the same crops, byte for byte, over
    more crops than the files hold frames (the files cycle)."""
    paths = []
    for i, (w, h, n) in enumerate(((64, 48, 3), (80, 64, 2))):
        path = tmp_path / f"{i}.y4m"
        path.write_bytes(_y4m(w, h, n, colorspace=colorspace, seed=10 + i))
        paths.append(str(path))
    ours = ttrainer.hr_crop_stream(paths, 32, np.random.default_rng(5))
    theirs = jtrainer.hr_crop_stream(paths, 32, np.random.default_rng(5))
    for _ in range(12):
        got, want = next(ours), next(theirs)
        assert got.shape == (32, 32, 3) and got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
        assert 0.0 <= got.min() and got.max() <= 1.0


def test_crop_larger_than_frame_rejected(media_dir):
    stream = ttrainer.hr_crop_stream([str(media_dir / "a.y4m")], crop=128,
                                     rng=np.random.default_rng(0))
    with pytest.raises(ValueError, match="smaller than crop"):
        next(stream)
    with pytest.raises(ValueError, match="no training media"):
        next(ttrainer.hr_crop_stream([], 32, np.random.default_rng(0)))


@pytest.mark.parametrize("scale", [2, 3])
def test_box_downsample_matches_reference(scale):
    hr = np.random.default_rng(scale).uniform(0, 1, (2, 12, 18, 3)).astype(np.float32)
    got = ttrainer.box_downsample(hr, scale)
    assert got.shape == (2, 12 // scale, 18 // scale, 3)
    assert got.tobytes() == jtrainer.box_downsample(hr, scale).tobytes()


# -- train() end to end against the reference's train() ------------------

E2E = dict(steps=6, batch=8, crop=32, log_every=1, features=16, depth=2,
           learning_rate=1e-3, seed=3)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """Both trainers resumed from one step-0 state: a flax init drawn with
    numpy, written with the JAX package's save_state into an orbax
    directory and, bridged with from_flax beside a fresh Adam, with the
    port's into its own.  Their crop streams are the same numpy stream."""
    root = tmp_path_factory.mktemp("e2e")
    media = root / "media"
    media.mkdir()
    (media / "a.y4m").write_bytes(_y4m(64, 48, frames=3, seed=1))
    (media / "b.y4m").write_bytes(_y4m(80, 64, frames=2, seed=2))
    jcfg = JaxConfig(features=16, depth=2)
    rng = np.random.default_rng(0)
    tree = {"params": {}}
    for name, k, cin, cout in (("stem", 5, 3, 16), ("body_0", 3, 16, 16),
                               ("subpixel", 3, 16, 12)):
        tree["params"][name] = {
            "kernel": (rng.standard_normal((k, k, cin, cout))
                       / np.sqrt(k * k * cin)).astype(np.float32),
            "bias": np.zeros(cout, np.float32)}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    orbax_dir, port_dir = str(root / "orbax"), str(root / "port")
    jckpt.save_state(orbax_dir, 0, jtree, optax.adam(1e-3).init(jtree))

    tcfg = UpscalerConfig(features=16, depth=2)
    engine = FrameUpscaler(tcfg, device="cpu", params=from_flax(tree, tcfg))
    model = engine.model.requires_grad_(True)
    tckpt.save_state(port_dir, 0, model.state_dict(),
                     make_optimizer(model).state_dict())

    paths = ttrainer.discover_media(str(media))
    jlines, tlines = [], []
    jsum = jtrainer.train(paths, jtrainer.TrainerSettings(
        checkpoint_dir=orbax_dir, **E2E), log=jlines.append)
    tsum = ttrainer.train(paths, ttrainer.TrainerSettings(
        checkpoint_dir=port_dir, **E2E), log=tlines.append, device="cpu")
    return dict(jax=(jsum, jlines), port=(tsum, tlines), orbax_dir=orbax_dir,
                port_dir=port_dir, media=str(media))


def test_train_tracks_reference_train_from_the_same_init(e2e):
    """bf16 compute on both sides, the reference's step sharded 8 ways:
    every logged loss within 1e-3 relative (the train step's bf16 bound,
    tests/test_torch_train.py; 5.8e-5 measured), the first within 1e-5
    (the forwards are bit-exact; the 6-decimal log rounds the loss by up
    to 5e-7 absolute; equal as logged)."""
    (jsum, jlines), (tsum, tlines) = e2e["jax"], e2e["port"]
    assert jlines[0] == tlines[0] == "resumed from step 0"
    want, got = _losses(jlines), _losses(tlines)
    assert list(got) == list(want) == [1, 2, 3, 4, 5, 6]
    rel = {s: abs(got[s] - want[s]) / want[s] for s in want}
    assert rel[1] < 1e-5, rel
    assert max(rel.values()) < 1e-3, rel
    assert got[6] < got[1]
    assert abs(tsum["final_loss"] - jsum["final_loss"]) / jsum["final_loss"] < 1e-3
    assert tsum["final_step"] == jsum["final_step"] == 6
    assert set(tsum) == set(jsum)
    assert (tsum["batch"], tsum["devices"], tsum["mesh"]) == (8, 1, None)
    assert tlines[-1] == "checkpoint saved at step 6"
    assert tckpt.latest_step(e2e["port_dir"]) == 6


def test_orbax_directory_of_the_reference_trainer_is_refused(e2e):
    """The reference trainer's orbax directory: the port reads its latest
    step as the JAX package restores it, so a reader of the same model
    starts from it, never from fresh weights; every reader of a model of
    another geometry refuses it with a ValueError naming orbax, and
    writes nothing."""
    orbax_dir = e2e["orbax_dir"]
    assert jckpt.latest_step(orbax_dir) == 6
    assert tckpt.latest_step(orbax_dir) == 6
    tcfg = UpscalerConfig(features=16, depth=2)
    like = FrameUpscaler(tcfg, device="cpu").model.state_dict()
    step, params, _ = tckpt.restore_state(orbax_dir, like)
    template = to_flax(params, tcfg)
    _, jparams, _ = jckpt.restore_state(orbax_dir, template,
                                        optax.adam(1e-3).init(template))
    assert step == 6
    want = from_flax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    assert all(torch.equal(params[k], want[k]) for k in want)

    paths = ttrainer.discover_media(e2e["media"])
    with pytest.raises(ValueError, match="orbax"):
        ttrainer.train(paths, ttrainer.TrainerSettings(
            checkpoint_dir=orbax_dir, **dict(E2E, features=8)), device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        FrameUpscaler(UpscalerConfig(features=8, depth=2), device="cpu",
                      checkpoint_dir=orbax_dir)
    with pytest.raises(ValueError, match="orbax"):  # the CLI's UpscalerConfig()
        cli_main(["upscale", os.path.join(e2e["media"], "a.y4m"),
                  os.path.join(e2e["media"], "out.y4m"), "--device", "cpu",
                  "--checkpoint-dir", orbax_dir])
    assert not os.path.exists(os.path.join(e2e["media"], "out.y4m"))
    assert tckpt.latest_step(orbax_dir) == 6


# -- the port's own loop ------------------------------------------------


def test_train_checkpoint_resume(media_dir, tmp_path):
    """Mirrors tests/test_trainer.py::test_train_checkpoint_resume."""
    ckpt = tmp_path / "ckpt"
    settings = ttrainer.TrainerSettings(steps=3, batch=2, crop=32, features=16,
                                        depth=2, checkpoint_dir=str(ckpt),
                                        save_every=100)
    paths = ttrainer.discover_media(str(media_dir))
    first = ttrainer.train(paths, settings, device="cpu")
    assert first["final_step"] == 3
    lines = []
    second = ttrainer.train(paths, settings, log=lines.append, device="cpu")
    assert lines[0] == "resumed from step 3"
    assert second["final_step"] == 6
    assert sorted(os.listdir(ckpt), key=int) == ["3", "6"]


def test_train_saves_every_n_steps_and_keeps_three(media_dir, tmp_path):
    ckpt = tmp_path / "ckpt"
    lines = []
    ttrainer.train(ttrainer.discover_media(str(media_dir)),
                   ttrainer.TrainerSettings(steps=8, batch=2, crop=32, features=8,
                                            depth=2, checkpoint_dir=str(ckpt),
                                            save_every=2, log_every=4),
                   log=lines.append, device="cpu")
    assert [line for line in lines if line.startswith("checkpoint")] == [
        f"checkpoint saved at step {s}" for s in (2, 4, 6, 8)]
    assert [int(line.split()[1]) for line in lines if line.startswith("step ")] == [1, 4, 8]
    assert sorted(os.listdir(ckpt), key=int) == ["4", "6", "8"]


def test_train_runs_on_one_device_and_raises_without_a_gpu(media_dir, monkeypatch):
    paths = ttrainer.discover_media(str(media_dir))
    # more than one visible card and no process group: train() hands the
    # loop to a group of one worker per card (NCCL), model axis and all
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 2)
        calls = []
        m.setattr(ttrainer, "train_in_group",
                  lambda *args, **kwargs: calls.append((args, kwargs)) or {})
        settings = ttrainer.TrainerSettings(steps=1, model_axis=2)
        ttrainer.train(paths, settings)
        assert calls == [((paths, settings, 2, "cuda"), {"log": None})]
    with pytest.raises(ValueError, match="not divisible"):
        ttrainer.train(paths, ttrainer.TrainerSettings(steps=1, crop=33),
                       device="cpu")
    # the default device is the card: no silent fallback to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.train(paths, ttrainer.TrainerSettings(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["train", "--data", str(media_dir), "--steps", "1"])


@pytest.mark.parametrize("features,depth", [(128, 4), (64, 2)])
def test_trained_checkpoint_loads_into_upscaler(media_dir, tmp_path, features, depth):
    """Mirrors tests/test_trainer.py::test_trained_checkpoint_loads_into_upscaler
    (the default geometry) and ::test_custom_geometry_checkpoint_matches_stage_config:
    the engine runs the trained params, not its seeded init."""
    ckpt = tmp_path / "ckpt"
    ttrainer.train(ttrainer.discover_media(str(media_dir)),
                   ttrainer.TrainerSettings(steps=2, batch=2, crop=32,
                                            checkpoint_dir=str(ckpt),
                                            features=features, depth=depth),
                   device="cpu")
    config = UpscalerConfig(features=features, depth=depth)
    engine = FrameUpscaler(config, batch=2, device="cpu", checkpoint_dir=str(ckpt))
    _, params, _ = tckpt.restore_state(str(ckpt), engine.model.state_dict())
    for name, value in engine.model.state_dict().items():
        assert torch.equal(value, params[name]), name
    assert not engine.model.training
    assert not any(p.requires_grad for p in engine.model.parameters())
    rng = np.random.default_rng(4)
    y = rng.integers(0, 256, (1, 16, 16), np.uint8)
    c = rng.integers(0, 256, (1, 8, 8), np.uint8)
    out = engine.upscale_batch(y, c, c, 2, 2)
    assert out[0].shape == (1, 32, 32)
    seeded = FrameUpscaler(config, batch=2, device="cpu").upscale_batch(y, c, c, 2, 2)
    assert not np.array_equal(out[0], seeded[0])
    with pytest.raises(ValueError, match="not both"):
        FrameUpscaler(config, device="cpu", params=params, checkpoint_dir=str(ckpt))


def test_cli_train_and_upscale(media_dir, tmp_path, capsys):
    """Mirrors tests/test_trainer.py::test_cli_train_and_upscale, on the
    CPU's plain path."""
    ckpt = tmp_path / "ckpt"
    rc = cli_main(["train", "--data", str(media_dir), "--steps", "2",
                   "--batch", "2", "--crop", "32", "--checkpoint-dir", str(ckpt),
                   "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "step 1 loss" in out
    assert "checkpoint saved at step 2" in out
    assert "trained to step 2" in out and "devices 1" in out

    dst = tmp_path / "out.y4m"
    rc = cli_main(["upscale", str(media_dir / "a.y4m"), str(dst),
                   "--checkpoint-dir", str(ckpt), "--batch", "2",
                   "--device", "cpu"])
    assert rc == 0
    assert "upscaled 3 frames" in capsys.readouterr().out
    with open(dst, "rb") as fh:
        header = Y4MReader(fh).header
    assert (header.width, header.height) == (128, 96)

    seeded = tmp_path / "seeded.y4m"
    assert cli_main(["upscale", str(media_dir / "a.y4m"), str(seeded),
                     "--batch", "2", "--device", "cpu"]) == 0
    assert seeded.read_bytes() != dst.read_bytes()

    # an empty checkpoint directory is an error, never the seeded init
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        cli_main(["upscale", str(media_dir / "a.y4m"), str(tmp_path / "x.y4m"),
                  "--checkpoint-dir", str(empty), "--device", "cpu"])
