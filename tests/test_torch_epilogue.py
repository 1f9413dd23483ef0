"""The conv epilogue (``compute/ops/conv_epilogue.py``) and the model's
two ways through it, on the CPU: with grad off the trunk and the head
hand each conv's output to ``conv_epilogue`` (on the card one kernel
pass, here its plain version), while autograd records they take
PyTorch's ops; both give the bytes of the three-op model."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from downloader_tpu_torch.compute.models import upscaler as tup
from downloader_tpu_torch.compute.ops.conv_epilogue import (
    conv_epilogue,
    conv_epilogue_plain,
)
from downloader_tpu_torch.compute.ops.pixel_shuffle import pixel_shuffle
from downloader_tpu_torch.compute.train import make_train_step


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def _nhwc_bf16(shape, seed: int, specials: bool = True) -> torch.Tensor:
    """A (B, C, H, W) channels_last bf16 tensor with negatives and, where
    ``specials``, +-0 and NaN among its values."""
    rng = np.random.default_rng(seed)
    b, c, h, w = shape
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    if specials:
        pick = rng.random(x.shape)
        x[pick < 0.05] = -0.0
        x[(pick >= 0.05) & (pick < 0.1)] = 0.0
        x[(pick >= 0.1) & (pick < 0.12)] = np.nan
    return torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)


VARIANTS = {"bias": (False, False), "relu": (True, False), "residual": (True, True)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_epilogue_is_the_three_ops(variant):
    """``conv_epilogue_plain``, and ``conv_epilogue`` on a CPU tensor (no
    launch), equal ``F.relu(y + b[:, None, None]) + x`` and its two
    shorter forms bit for bit, +-0 and NaN included."""
    relu, residual = VARIANTS[variant]
    y = _nhwc_bf16((2, 16, 5, 7), seed=1)
    x = _nhwc_bf16((2, 16, 5, 7), seed=2) if residual else None
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(16)
                         .astype(np.float32)).to(torch.bfloat16)
    b[0], b[1], b[2] = -0.0, 0.0, float("nan")
    want = y + b[:, None, None]
    if relu:
        want = F.relu(want)
    if residual:
        want = want + x
    before = conv_epilogue.launches
    for fn in (conv_epilogue_plain, conv_epilogue):
        got = fn(y, b, relu, x)
        assert got.dtype == torch.bfloat16
        assert torch.equal(_bits(got), _bits(want)), fn.__name__
    assert conv_epilogue.launches == before


def _three_op_forward(model: tup.Upscaler, frames: torch.Tensor, stop: str):
    """The model as three PyTorch ops after every conv, written out:
    ``trunk``, ``backbone`` or ``forward`` by ``stop``."""
    dt = model.config.compute_dtype

    def conv(c, x):
        y = F.conv2d(x, c.weight.to(dt), None, padding=c.padding)
        return y + c.bias.to(dt)[:, None, None]

    x = frames.to(dt).permute(0, 3, 1, 2)
    x = F.relu(conv(model.stem, x))
    for c in model.convs()[1:-1]:
        x = F.relu(conv(c, x)) + x
    if stop == "trunk":
        return x.permute(0, 2, 3, 1)
    maps = conv(model.subpixel, x).permute(0, 2, 3, 1)
    return maps if stop == "backbone" else pixel_shuffle(maps, model.config.scale)


def _model(scale: int, seed: int) -> tup.Upscaler:
    """A small bf16 model with biases off zero, so every bias counts."""
    model = tup.Upscaler(tup.UpscalerConfig(scale=scale, features=16, depth=4),
                         seed=seed)
    with torch.no_grad():
        for conv in model.convs():
            conv.bias.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(seed))
    return model


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("method", ["trunk", "backbone", "forward"])
def test_inference_mode_equals_the_grad_path(scale, method):
    """Under ``torch.inference_mode()`` (the engine's and ``infer``'s
    mode) and with grad recorded (the train step's), ``trunk``,
    ``backbone`` and ``forward`` give the same bits as the three-op
    model."""
    model = _model(scale, seed=scale)
    frames = torch.from_numpy(np.random.default_rng(scale).uniform(
        -0.2, 1.2, (2, 9, 11, 3)).astype(np.float32))
    with torch.inference_mode():
        fused = getattr(model, method)(frames)
    with torch.enable_grad():
        graded = getattr(model, method)(frames)
    assert graded.requires_grad
    with torch.no_grad():
        want = _three_op_forward(model, frames, method)
    assert fused.dtype == want.dtype == torch.bfloat16
    assert torch.equal(_bits(fused), _bits(want))
    assert torch.equal(_bits(graded.detach()), _bits(want))


@pytest.mark.parametrize("scale", [2, 4])
def test_the_model_routes_its_epilogues_by_grad_mode(scale, monkeypatch):
    """With grad off a bf16 model hands each conv's output to
    ``conv_epilogue``: 4 calls for the trunk (stem and three body convs),
    5 for the backbone (and the head); none while autograd records, and
    none in f32 compute, which the kernel does not take."""
    calls = []

    def counted(y, bias, relu=False, residual=None):
        calls.append((y.shape[1], relu, residual is not None))
        return conv_epilogue_plain(y, bias, relu, residual)

    monkeypatch.setattr(tup, "conv_epilogue", counted)
    model = _model(scale, seed=7)
    frames = torch.rand(1, 6, 8, 3)
    with torch.inference_mode():
        model.trunk(frames)
        assert calls == [(16, True, False)] + [(16, True, True)] * 3
        calls.clear()
        model.backbone(frames)
        assert calls[-1] == (3 * scale * scale, False, False) and len(calls) == 5
        calls.clear()
    model(frames).sum().backward()
    assert calls == []
    f32 = tup.Upscaler(tup.UpscalerConfig(scale=scale, features=16, depth=4,
                                          compute_dtype=torch.float32))
    with torch.inference_mode():
        f32(frames)
    assert calls == []


def test_train_step_keeps_the_three_op_loss_and_gradients():
    """A CPU ``train_step`` gives the loss and every gradient of the
    three-op model's MSE, bit for bit, and launches no epilogue."""
    step, init = make_train_step(tup.UpscalerConfig(features=16, depth=4),
                                 device="cpu")
    state, twin = init(5), init(5)
    rng = np.random.default_rng(5)
    low = torch.from_numpy(rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32))
    high = torch.from_numpy(rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32))
    err = _three_op_forward(twin.model, low, "forward").float() - high
    want = torch.mean(err * err)
    want.backward()
    before = conv_epilogue.launches
    got = step(state, low, high)
    assert conv_epilogue.launches == before
    assert torch.equal(got, want.detach())
    for (name, p), q in zip(state.model.named_parameters(), twin.model.parameters()):
        assert torch.equal(p.grad, q.grad), name
