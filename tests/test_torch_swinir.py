"""SwinIR-M x4 (real-world) in the port, on the CPU at a tiny size:
embed 12, two heads, two RSTBs of two blocks, window 4, 8 tail features,
frames of 10x14 (not a multiple of the window, so the reflect padding and
the shift masks of a padded size run), at x4.

The port is held to the plain float32 forward of ``tests/plain_swinir.py``
(and that copy to the benchmark's, ``portbench/reference/swinir.py``) on
seeded weights that make the attention matter: linear kernels of unit
gain and bias tables of std 2, so that leaving out the shift mask or the
bias moves the output by several times what bf16 rounding does.
"""

import dataclasses
import io
import math

import numpy as np
import pytest
import torch

import plain_swinir
from downloader_tpu_torch.compute.models import (
    MODELS,
    SwinIRConfig,
    build_model,
    model_config,
)
from downloader_tpu_torch.compute.models.swinir import (
    SwinIR,
    relative_position_index,
    shift_mask,
)
from downloader_tpu_torch.compute.pipeline import FrameUpscaler
from downloader_tpu_torch.compute.video import Y4MHeader, Y4MReader, Y4MWriter

TINY = SwinIRConfig(embed_dim=12, depths=(2, 2), num_heads=(2, 2), window_size=4,
                    num_feat=8)
TINY_F32 = dataclasses.replace(TINY, compute_dtype=torch.float32)
HEIGHT, WIDTH = 10, 14
# bf16 activations against the f32 reference: the largest |gap| over the
# output (RGB in [0, 1]).  Readings on these weights: ~5e-4 at bf16;
# ~3e-3 with the shift mask left out of the reference and ~7e-3 with the
# bias left out.  1.5e-3 is three bf16 readings and half the nearer part.
BF16_TOL = 1.5e-3


def _weights(config: SwinIRConfig, seed: int) -> dict:
    """Seeded weights under the official names (see module docstring)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, value in build_model(config, seed=None).state_dict().items():
        if name.endswith("relative_position_bias_table"):
            out[name] = torch.randn(value.shape, generator=g) * 2.0
        elif "norm" in name:
            base = 1.0 if name.endswith("weight") else 0.0
            out[name] = base + 0.1 * torch.randn(value.shape, generator=g)
        elif name.endswith(".bias"):
            out[name] = torch.randn(value.shape, generator=g) * 0.1
        elif value.dim() == 2:
            out[name] = torch.randn(value.shape, generator=g) / math.sqrt(value.shape[1])
        else:
            out[name] = value
    return out


def _port(config: SwinIRConfig, weights: dict) -> SwinIR:
    model = build_model(config)
    model.load_state_dict(weights)
    return model.eval()


def _frames(seed: int, n: int = 2) -> torch.Tensor:
    return torch.rand((n, HEIGHT, WIDTH, 3), generator=torch.Generator().manual_seed(seed))


def _plain(weights, frames, leave_out=(), config=TINY_F32):
    conf = dataclasses.asdict(config)
    nchw = plain_swinir.forward(weights, frames.permute(0, 3, 1, 2), conf, leave_out)
    return nchw.permute(0, 2, 3, 1)


@pytest.mark.parametrize("seed", [1, 2])
def test_port_f32_matches_plain_reference(seed):
    """The same operations in another order: f32 agrees to 1e-5."""
    weights = _weights(TINY_F32, seed)
    frames = _frames(seed + 10)
    with torch.inference_mode():
        got = _port(TINY_F32, weights)(frames)
    assert got.shape == (2, 4 * HEIGHT, 4 * WIDTH, 3)
    assert (got - _plain(weights, frames)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("seed", [1, 2])
def test_port_bf16_within_tolerance(seed):
    weights = _weights(TINY, seed)
    frames = _frames(seed + 10)
    with torch.inference_mode():
        got = _port(TINY, weights)(frames)
    assert (got - _plain(weights, frames)).abs().max().item() <= BF16_TOL


@pytest.mark.parametrize("part", ["shift_mask", "bias"])
@pytest.mark.parametrize("seed", [1, 2])
def test_tolerance_sees_a_missing_part(part, seed):
    """The reference without the shift mask, or without the bias, is
    outside the bf16 tolerance: it is tight enough to see either gone."""
    weights = _weights(TINY, seed)
    frames = _frames(seed + 10)
    gap = (_plain(weights, frames, [part]) - _plain(weights, frames)).abs().max().item()
    assert gap > BF16_TOL


def test_benchmark_reference_copy_gives_identical_output():
    from portbench.reference import swinir as bench_reference

    weights = _weights(TINY_F32, 5)
    frames = _frames(15).permute(0, 3, 1, 2)
    conf = dataclasses.asdict(TINY_F32)
    assert torch.equal(bench_reference.forward(weights, frames, conf),
                       plain_swinir.forward(weights, frames, conf))


def _y4m(frames: int, seed: int) -> bytes:
    hdr = Y4MHeader(width=WIDTH, height=HEIGHT, colorspace="420jpeg")
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    writer = Y4MWriter(buf, hdr)
    for _ in range(frames):
        writer.write_frame(rng.integers(0, 256, (HEIGHT, WIDTH), np.uint8),
                           rng.integers(0, 256, hdr.chroma_shape, np.uint8),
                           rng.integers(0, 256, hdr.chroma_shape, np.uint8))
    return buf.getvalue()


def _reference_planes(weights, y, cb, cr, config=TINY_F32):
    """The plain reference's u8 planes of one frame's u8 planes."""
    from portbench.reference.upscaler import to_planes, unit_rgb

    rgb = unit_rgb(*(torch.from_numpy(p.copy())[None] for p in (y, cb, cr)))
    out = _plain(weights, rgb.permute(0, 2, 3, 1), config=config).permute(0, 3, 1, 2)
    return [p[0].numpy() for p in to_planes(out, y.shape[0] // cb.shape[0],
                                             y.shape[1] // cb.shape[1])]


def test_engine_upscale_to_matches_reference_u8_planes():
    """``upscale_to`` on a 4:2:0 stream (a short last batch too) against
    the plain reference's u8 planes: within one step."""
    weights = _weights(TINY, 3)
    engine = FrameUpscaler(config=TINY, batch=2, params=weights, device="cpu")
    src = _y4m(3, seed=7)
    dst = io.BytesIO()
    assert engine.upscale_to(io.BytesIO(src), dst) == 3
    got = list(Y4MReader(io.BytesIO(dst.getvalue())))
    frames = list(Y4MReader(io.BytesIO(src)))
    for planes, out in zip(frames, got):
        for g, w in zip(out, _reference_planes(weights, *planes)):
            assert g.shape == w.shape
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1


def test_engine_never_tiles_swinir():
    """4K frames at batch 1 tile (4, 4) under ESPCN; SwinIR has no finite
    halo, so the engine never cuts it, and ``batch_for`` alone caps it."""
    espcn = FrameUpscaler(batch=1, device="cpu")
    swin = FrameUpscaler(config=TINY, batch=1, device="cpu")
    assert espcn.tile_grid(2160, 3840, 2, 2) != (1, 1)
    assert swin.model.halo is None
    assert swin.tile_grid(2160, 3840, 2, 2) == (1, 1)
    assert swin.batch_for(2160, 3840) == espcn.batch_for(2160, 3840)


def test_engine_takes_the_generic_tail_at_every_subsampling():
    """No s2d or odd-dims branch without ESPCN's trunk: 4:4:4 frames go
    through the generic tail too."""
    engine = FrameUpscaler(config=TINY, batch=2, device="cpu")
    rng = np.random.default_rng(3)
    y = rng.integers(0, 256, (2, HEIGHT, WIDTH), np.uint8)
    out = engine.upscale_batch(y, y, y, 1, 1)
    assert [p.shape for p in out] == [(2, 4 * HEIGHT, 4 * WIDTH)] * 3


OFFICIAL_BLOCK = ("norm1.weight", "norm1.bias", "attn.relative_position_bias_table",
                  "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight",
                  "attn.proj.bias", "norm2.weight", "norm2.bias", "mlp.fc1.weight",
                  "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")
OFFICIAL_TOP = ("conv_first", "patch_embed.norm", "norm", "conv_after_body",
                "conv_before_upsample.0", "conv_up1", "conv_up2", "conv_hr",
                "conv_last")


def test_state_dict_keys_are_the_official_names():
    want = {f"{m}.{leaf}" for m in OFFICIAL_TOP for leaf in ("weight", "bias")}
    for i, depth in enumerate(TINY.depths):
        want |= {f"layers.{i}.conv.weight", f"layers.{i}.conv.bias"}
        want |= {f"layers.{i}.residual_group.blocks.{j}.{leaf}"
                 for j in range(depth) for leaf in OFFICIAL_BLOCK}
    assert set(build_model(TINY).state_dict()) == want


def test_official_state_dict_with_buffers_loads():
    """A published file's dict (under ``params_ema``, with the recomputed
    index and mask buffers) loads; a wrong index is refused."""
    weights = _weights(TINY, 4)
    official = dict(weights)
    for i, depth in enumerate(TINY.depths):
        for j in range(depth):
            p = f"layers.{i}.residual_group.blocks.{j}.attn"
            official[f"{p}.relative_position_index"] = relative_position_index(4)
            if j % 2:
                official[f"layers.{i}.residual_group.blocks.{j}.attn_mask"] = \
                    shift_mask(64, 64, 4, 2)
    model = build_model(TINY)
    model.load_state_dict({"params_ema": official})
    assert all(torch.equal(model.state_dict()[k], v) for k, v in weights.items())
    official["layers.0.residual_group.blocks.0.attn.relative_position_index"] = (
        relative_position_index(4).flip(0))
    with pytest.raises(ValueError, match="relative_position_index"):
        build_model(TINY).load_state_dict(official)


def test_masks_built_once_per_size_and_rebuilt_for_new_weights():
    """The region mask is cached per padded size; each block's mask is
    its current bias, plus the regions on a shifted block."""
    model = build_model(TINY).eval()
    regions = model.regions(12, 16)
    assert model.regions(12, 16) is regions
    assert regions.shape == (12, 1, 16, 16) and regions.dtype == TINY.compute_dtype
    plain, shifted = model.layers[0].residual_group.blocks[:2]
    masks = [plain.attn.mask(None, torch.bfloat16),
             shifted.attn.mask(regions, torch.bfloat16)]
    # an unshifted block's mask is the bias alone, shared by every window
    assert masks[0].shape == (1, 2, 16, 16) and masks[1].shape == (12, 2, 16, 16)
    # the card's fused attention kernels take only masks whose last dim
    # has unit stride (the bias gathers out permuted)
    assert all(m.is_contiguous() for m in masks)
    assert torch.equal(masks[1], regions + shifted.attn.mask(None, torch.bfloat16))
    model.load_state_dict(_weights(TINY, 6))
    bias = shifted.attn.bias().to(torch.bfloat16)
    assert not torch.equal(bias, masks[1][0])
    assert torch.equal(shifted.attn.mask(regions, torch.bfloat16), regions + bias[None])


def test_engine_bills_the_mask_build_once_per_size(monkeypatch):
    """The region mask is built once per padded size; its span, like the
    attention's, is timed on CUDA only, so the CPU bills neither."""
    from downloader_tpu_torch.compute.models import swinir

    builds = []
    real = swinir.shift_mask
    monkeypatch.setattr(swinir, "shift_mask",
                        lambda *a, **k: builds.append(a[:2]) or real(*a, **k))
    engine = FrameUpscaler(config=TINY, batch=2, device="cpu")
    notes = []
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (2, HEIGHT, WIDTH), np.uint8)
    c = rng.integers(0, 256, (2, HEIGHT // 2, WIDTH // 2), np.uint8)
    with engine.hop_sink.bound(lambda hop, nbytes, s: notes.append(hop)):
        engine.upscale_batch(y, c, c, 2, 2)
        engine.upscale_batch(y, c, c, 2, 2)
    assert builds == [(12, 16)]
    assert "attention" not in notes and "mask" not in notes


def test_span_hops_sum_a_shard_and_take_the_longest():
    from downloader_tpu_torch.compute.pipeline import _span_hops

    class Event:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, end):
            return end.ms - self.ms

    def span(nbytes, ms):
        return ("attention", nbytes, Event(0.0), Event(ms))

    hops = _span_hops([[span(10, 2.0), span(10, 3.0)], [span(10, 4.0)]])
    assert hops == {"attention": (30, pytest.approx(0.005))}


def test_model_choice_builds_the_config():
    assert MODELS == ("espcn", "swinir-m-x4-real")
    assert model_config("swinir-m-x4-real") == SwinIRConfig()
    assert model_config("espcn", scale=4).scale == 4
    with pytest.raises(ValueError, match="unknown upscale model"):
        model_config("hat")
    full = SwinIRConfig()
    assert (full.embed_dim, full.depths, full.num_heads, full.window_size,
            full.mlp_ratio, full.num_feat, full.upsampler) == (
        180, (6,) * 6, (6,) * 6, 8, 2.0, 64, "nearest+conv")


def test_cli_offers_the_same_models():
    from downloader_tpu_torch.cli import _build_parser

    parser = _build_parser()
    args = parser.parse_args(["upscale", "a.y4m", "b.y4m", "--model",
                              "swinir-m-x4-real"])
    assert args.model == "swinir-m-x4-real"
    assert parser.parse_args(["upscale", "a.y4m", "b.y4m"]).model == "espcn"
    upscale = parser._subparsers._group_actions[0].choices["upscale"]
    model = next(a for a in upscale._actions if a.dest == "model")
    assert tuple(model.choices) == MODELS


def test_stage_builds_the_swinir_engine(tmp_path, monkeypatch):
    """``instance.upscale.model`` picks the engine's model; SwinIR
    outputs are named ``.4x``; an unknown name fails at load."""
    from downloader_tpu_torch.compute import models
    from downloader_tpu_torch.platform.config import ConfigNode
    from downloader_tpu_torch.stages import upscale as stage

    def config(model):
        return ConfigNode({"instance": {"upscale": {
            "enabled": True, "device": "cpu", "batch": 2, "model": model}}})

    opts = stage._engine_config(config("swinir-m-x4-real"))
    assert stage._model_config(opts).scale == 4
    assert stage._model_config(stage._engine_config(config("espcn"))).scale == 2
    # the published widths are too slow for a CPU test: the stage's
    # choice resolves to the tiny config
    monkeypatch.setattr(models, "model_config",
                        lambda name, **_: TINY if name == "swinir-m-x4-real" else None)

    class Ctx:
        resources: dict = {}

    ctx = Ctx()
    ctx.config = config("swinir-m-x4-real")
    engine = stage._get_engine(ctx)
    assert isinstance(engine.model, SwinIR) and engine.config == TINY
    with pytest.raises(ValueError, match="instance.upscale.model"):
        stage._engine_config(config("hat"))


def test_training_refuses_swinir(tmp_path):
    """The train steps and the trainer's checkpoints, the places a SwinIR
    config can reach, refuse it."""
    from downloader_tpu_torch.compute.train import compile_train_step, make_train_step

    with pytest.raises(ValueError, match="served only"):
        compile_train_step(TINY, device="cpu")
    with pytest.raises(ValueError, match="served only"):
        make_train_step(TINY, device="cpu")
    with pytest.raises(ValueError, match="served only"):
        FrameUpscaler(config=TINY, device="cpu", checkpoint_dir=str(tmp_path))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused attention kernels and the "
                    "attention spans exist on CUDA only")


# the published head size (30, padded to 32 inside the weights) and window
CARD = SwinIRConfig(embed_dim=60, depths=(2, 2), num_heads=(2, 2), num_feat=16)


@pytest.mark.cuda
def test_card_takes_a_fused_attention_kernel_and_bills_its_spans(card):
    """On the card the attention runs one of SDPA's fused kernels, never its
    math backend (a mask without a unit-stride last dim sends it there);
    each dispatch bills one ``attention`` hop, and the output stays within
    two u8 steps of the plain reference (the CPU's bf16 path reads one; the
    card's kernels sum in another order)."""
    weights = _weights(CARD, 7)
    engine = FrameUpscaler(config=CARD, batch=2, params=weights, devices=["cuda:0"])
    rng = np.random.default_rng(9)
    y = rng.integers(0, 256, (2, 36, 52), np.uint8)
    cb, cr = (rng.integers(0, 256, (2, 18, 26), np.uint8) for _ in range(2))
    notes = []
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with engine.hop_sink.bound(lambda hop, nbytes, s: notes.append((hop, nbytes, s))):
        engine.upscale_batch(y, cb, cr, 2, 2)
        with torch.profiler.profile(activities=activities) as prof:
            got = engine.upscale_batch(y, cb, cr, 2, 2)
    names = {event.key for event in prof.key_averages()}
    assert "aten::_scaled_dot_product_attention_math" not in names
    assert names & {"aten::_scaled_dot_product_cudnn_attention",
                    "aten::_scaled_dot_product_efficient_attention",
                    "aten::_scaled_dot_product_flash_attention"}
    attention = [(nbytes, s) for hop, nbytes, s in notes if hop == "attention"]
    assert len(attention) == 2 and all(nbytes > 0 and s > 0 for nbytes, s in attention)
    assert [hop for hop, _, _ in notes].count("mask") == 1
    config = dataclasses.replace(CARD, compute_dtype=torch.float32)
    for i in range(2):
        want = _reference_planes(weights, y[i], cb[i], cr[i], config)
        for g, w in zip((p[i] for p in got), want):
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 2
