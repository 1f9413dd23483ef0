"""The plain references: against a float64 forward written out tap by
tap, and against the program's own float32 paths on the CPU, at tiny
sizes."""

import numpy as np
import pytest
import torch

from portbench import seeded
from portbench.reference import train as ref_train
from portbench.reference import upscaler as ref

CONFIG = {"features": 8, "depth": 3, "channels": 3, "head_gain": 0.5,
          "head_bias": 0.5, "bias_std": 0.02}


def _conv64(x, w, b):
    """SAME conv of (C, H, W) by (O, C, k, k), float64, tap by tap."""
    k = w.shape[-1]
    pad = np.pad(x, ((0, 0), (k // 2, k // 2), (k // 2, k // 2)))
    out = np.zeros((w.shape[0],) + x.shape[1:])
    for i in range(k):
        for j in range(k):
            out += np.einsum("oc,chw->ohw", w[:, :, i, j],
                             pad[:, i:i + x.shape[1], j:j + x.shape[2]])
    return out + b[:, None, None]


def _forward64(weights, rgb, scale, depth):
    w = {k: v.double().numpy() for k, v in weights.items()}
    names = ref.conv_names(depth)
    x = np.maximum(_conv64(rgb, w["stem.weight"], w["stem.bias"]), 0)
    for name, _ in names[1:-1]:
        x = np.maximum(_conv64(x, w[f"{name}.weight"], w[f"{name}.bias"]), 0) + x
    sub = _conv64(x, w["subpixel.weight"], w["subpixel.bias"])
    c, h, wd = sub.shape
    # channel (di*r + dj)*3 + colour lands at (h*r + di, w*r + dj)
    return (sub.reshape(scale, scale, 3, h, wd).transpose(2, 3, 0, 4, 1)
            .reshape(3, h * scale, wd * scale))


@pytest.mark.parametrize("scale", [2, 4])
def test_forward_against_float64_by_taps(scale):
    config = dict(CONFIG, scale=scale)
    weights = seeded.weights(config, 11, "cpu")
    rgb = torch.rand((1, 3, 10, 12), generator=torch.Generator().manual_seed(3))
    got = ref.forward(weights, rgb, scale, config["depth"])[0].double().numpy()
    want = _forward64(weights, rgb[0].double().numpy(), scale, config["depth"])
    assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("scale", [2, 4])
def test_upscale_against_the_programs_float32_path(scale):
    from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler

    config = dict(CONFIG, scale=scale)
    weights = seeded.weights(config, 5, "cpu")
    y, cb, cr = seeded.frames(2, 32, 48, 2, 6, "cpu")
    engine = FrameUpscaler(UpscalerConfig(scale=scale, features=8, depth=3,
                                          compute_dtype=torch.float32),
                           batch=2, params=weights, device="cpu")
    got = engine.upscale_batch(y.numpy(), cb.numpy(), cr.numpy(), 2, 2)
    want = ref.upscale(weights, y, cb, cr, scale, 3)
    for g, w in zip(got, want):
        d = np.abs(g.astype(int) - w.numpy().astype(int))
        assert d.max() <= 1 and (d == 0).mean() > 0.99


def test_crops_are_the_trainers(tmp_path):
    from downloader_tpu_torch.compute.trainer import box_downsample, hr_crop_stream
    from portbench.traffic.train import write_clip

    path = str(tmp_path / "clip.y4m")
    write_clip(path, [p.numpy() for p in seeded.frames(3, 32, 48, 2, 8, "cpu")])
    seed = 2**40 + 3
    stream = hr_crop_stream([path], 16, np.random.default_rng(seed))
    want = np.stack([next(stream) for _ in range(7)])
    got = ref_train.crops(path, 16, seed, 7)
    assert np.abs(got - want).max() <= 1e-6
    assert np.abs(ref_train.box_downsample(got, 2) - box_downsample(want, 2)).max() <= 1e-6


def test_steps_against_the_programs_float32_step():
    from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
    from downloader_tpu_torch.compute.train import make_train_step

    config = dict(CONFIG, scale=2)
    weights = seeded.weights(config, 9, "cpu")
    gen = torch.Generator().manual_seed(4)
    batches = [(torch.rand((2, 6, 6, 3), generator=gen).numpy(),
                torch.rand((2, 12, 12, 3), generator=gen).numpy()) for _ in range(3)]
    step, init_state = make_train_step(
        UpscalerConfig(scale=2, features=8, depth=3, compute_dtype=torch.float32),
        learning_rate=1e-3, device="cpu")
    state = init_state(0)
    state.model.load_state_dict(weights)
    losses = [float(step(state, torch.from_numpy(lo), torch.from_numpy(hi)))
              for lo, hi in batches]
    want_losses, _, want_after = ref_train.steps(weights, batches, 2, 3, 1e-3)
    assert losses == pytest.approx(want_losses, rel=1e-5)
    for name, p in state.model.named_parameters():
        assert torch.allclose(p.detach(), want_after[name], atol=1e-5), name
