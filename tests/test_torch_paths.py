"""The port's other inference paths, on the CPU, held against the JAX
package on the same (bridged) weights: spatial tiling, the generic tail
(4:4:4 and 4:2:2 at scale 2), the odd-dims branch (scale 1 on 4:4:4) and
the RGB ``infer`` path.  On the card the same paths launch the CUDA
kernels; ``chip_smoke.py`` drives them there."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from downloader_tpu.compute import infer as jax_infer
from downloader_tpu.compute import pipeline as jax_pipeline
from downloader_tpu.compute.models.upscaler import UpscalerConfig as JaxConfig
from downloader_tpu_torch.compute import infer as port_infer
from downloader_tpu_torch.compute import pipeline as port_pipeline
from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
from downloader_tpu_torch.compute.ops import pixel_shuffle as tps
from downloader_tpu_torch.compute.video import Y4MHeader, Y4MReader, Y4MWriter
from downloader_tpu_torch.compute.weights import to_flax


def _y4m(width, height, frames, colorspace, seed) -> bytes:
    hdr = Y4MHeader(width=width, height=height, colorspace=colorspace)
    ch, cw = hdr.chroma_shape
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    writer = Y4MWriter(buf, hdr)
    for _ in range(frames):
        writer.write_frame(rng.integers(0, 256, (height, width), np.uint8),
                           rng.integers(0, 256, (ch, cw), np.uint8),
                           rng.integers(0, 256, (ch, cw), np.uint8))
    return buf.getvalue()


def _read(path):
    with open(path, "rb") as fh:
        reader = Y4MReader(fh)
        return reader.header, list(reader)


def _pair(scale=2, batch=2, seed=7):
    """A port engine (CPU, seeded) and a JAX engine carrying its weights."""
    config = UpscalerConfig(features=8, depth=2, scale=scale)
    port = port_pipeline.FrameUpscaler(config, batch=batch, seed=seed, device="cpu")
    ref = jax_pipeline.FrameUpscaler(
        config=JaxConfig(features=8, depth=2, scale=scale), batch=batch,
        use_mesh=False)
    tree = to_flax(port.model.state_dict(), config)
    ref.params = {"params": {m: {k: jnp.asarray(v) for k, v in leaves.items()}
                             for m, leaves in tree["params"].items()}}
    return port, ref


def _within_reference_bound(got, want):
    """The reference's own bound for the same graph computed another way
    (tests/test_upscale.py): <= 1 u8 step, > 97% of bytes exact."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() > 0.97, (diff == 0).mean()


@pytest.mark.parametrize("height,width,sub,batch", [
    (2160, 3840, (2, 2), 2),   # 4K 4:2:0 at batch_for's 2
    (2160, 3840, (1, 1), 1),
    (4320, 7680, (2, 2), 1),
    (1080, 1920, (2, 2), 8),   # 1080p at batch 8: never tiled
    (1077, 1919, (2, 2), 2),   # indivisible: untiled rather than guessed
    (48, 64, (2, 2), 2),       # under TILE_MIN_PX
])
def test_tile_grid_and_anchors_match_reference(height, width, sub, batch):
    for depth in (2, 4):
        halo = port_pipeline._tile_halo(depth)
        assert halo == jax_pipeline._tile_halo(depth)
        grid = port_pipeline._tile_grid(height, width, *sub, halo, batch=batch)
        assert grid == jax_pipeline._tile_grid(height, width, *sub, halo,
                                               batch=batch)
        for dim, splits in ((height, grid[0]), (width, grid[1])):
            assert (port_pipeline._tile_anchors(dim, splits, halo)
                    == jax_pipeline._tile_anchors(dim, splits, halo))


def test_4k_tiles_four_by_four_at_full_width():
    """The shipping config on a 4K 4:2:0 stream: batch_for gives 2
    frames, the grid is (4, 4), so each dispatch holds 32 tiles of
    556 x 976 (halo 8) — every tile even, so each takes the s2d branch."""
    engine = port_pipeline.FrameUpscaler(device="cpu")
    assert engine.batch_for(2160, 3840) == 2
    assert engine.tile_grid(2160, 3840, 2, 2) == (4, 4)
    halo = port_pipeline._tile_halo(engine.config.depth)
    assert halo == 8
    assert (2160 // 4 + 2 * halo, 3840 // 4 + 2 * halo) == (556, 976)
    assert engine.tile_grid(1080, 1920, 2, 2) == (1, 1)


@pytest.mark.parametrize("colorspace,sub", [("420jpeg", (2, 2)), ("444", (1, 1))])
def test_tiled_matches_untiled_and_jax(monkeypatch, colorspace, sub):
    """Mirrors the reference's test_tiled_matches_untiled: with the size
    gate lowered, a small batch-starved frame tiles; the port's tiled
    output is byte-for-byte its untiled output, and within the
    reference's bound of the JAX engine's tiled output."""
    port, ref = _pair(batch=2)
    rng = np.random.default_rng(1)
    ch, cw = 48 // sub[0], 64 // sub[1]
    y = rng.integers(0, 256, (2, 48, 64), dtype=np.uint8)
    cb = rng.integers(0, 256, (2, ch, cw), dtype=np.uint8)
    cr = rng.integers(0, 256, (2, ch, cw), dtype=np.uint8)
    untiled = port.upscale_batch(y, cb, cr, *sub)

    monkeypatch.setattr(port_pipeline, "TILE_MIN_PX", 1000)
    monkeypatch.setattr(jax_pipeline, "TILE_MIN_PX", 1000)
    assert port.tile_grid(48, 64, *sub) == (2, 4)
    tiled = port.upscale_batch(y, cb, cr, *sub)
    want = ref.upscale_batch(y, cb, cr, *sub)
    for t, u, w in zip(tiled, untiled, want):
        np.testing.assert_array_equal(t, u)
        _within_reference_bound(t, w)


@pytest.mark.parametrize("colorspace,width,height", [
    ("444", 18, 14),
    ("422", 16, 12),
])
def test_generic_tail_matches_jax_engine(tmp_path, colorspace, width, height):
    """Mirrors test_frame_upscaler_handles_444_via_generic_tail: chroma
    subsampling != scale takes the full forward, RGB->YCbCr, the chroma
    box filter and three standalone quantizes."""
    port, ref = _pair(batch=2)
    src = tmp_path / "clip.y4m"
    src.write_bytes(_y4m(width, height, 3, colorspace, seed=2))
    before = tps.quantize_u8.launches
    assert port.upscale_y4m(str(src), str(tmp_path / "port.y4m")) == 3
    assert tps.quantize_u8.launches == before  # the plain path on the CPU
    assert ref.upscale_y4m(str(src), str(tmp_path / "ref.y4m")) == 3
    (hdr, got), (ref_hdr, want) = (_read(tmp_path / "port.y4m"),
                                   _read(tmp_path / "ref.y4m"))
    assert (hdr.width, hdr.height, hdr.colorspace) == (2 * width, 2 * height,
                                                       colorspace)
    assert (ref_hdr.width, ref_hdr.height) == (hdr.width, hdr.height)
    assert got[0][1].shape == (2 * height, 2 * width // (2 if colorspace == "422" else 1))
    for g_frame, w_frame in zip(got, want):
        for g, w in zip(g_frame, w_frame):
            _within_reference_bound(g, w)


@pytest.mark.parametrize("width,height", [
    (17, 13),    # odd dims: plain head + fused sub-pixel tail
    (16, 12),    # even dims: the s2d head with the plain tail
], ids=["odd", "s2d"])
def test_scale_one_444_matches_jax_engine(tmp_path, width, height):
    """The odd-dims branch needs chroma subsampling == scale and odd
    frame dims: a 4:2:0 Y4M cannot carry odd dims, so the configuration
    that reaches it is scale 1 on 4:4:4.  The even case at scale 1 takes
    the s2d branch: the s2d head and, on the CPU, the plain s2d tail."""
    port, ref = _pair(scale=1, batch=2)
    src = tmp_path / "clip.y4m"
    src.write_bytes(_y4m(width, height, 3, "444", seed=3))
    assert port.upscale_y4m(str(src), str(tmp_path / "port.y4m")) == 3
    assert ref.upscale_y4m(str(src), str(tmp_path / "ref.y4m")) == 3
    (hdr, got), (_, want) = (_read(tmp_path / "port.y4m"),
                             _read(tmp_path / "ref.y4m"))
    assert (hdr.width, hdr.height) == (width, height)
    for g_frame, w_frame in zip(got, want):
        for g, w in zip(g_frame, w_frame):
            _within_reference_bound(g, w)


@pytest.mark.parametrize("scale", [1, 2, 3])
def test_s2d_branch_matches_jax_engine_at_every_scale(scale):
    """Chroma subsampling == scale with even frame dims takes the s2d head
    and the s2d tail at any scale (on the card, the tail kernel; no scale
    is refused).  Planes cut for subsampling ``scale`` go through both
    engines' ``upscale_batch``."""
    port, ref = _pair(scale=scale, batch=2)
    rng = np.random.default_rng(20 + scale)
    h, w = 12 * scale, 16 * scale
    y = rng.integers(0, 256, (2, h, w), np.uint8)
    cb, cr = (rng.integers(0, 256, (2, h // scale, w // scale), np.uint8)
              for _ in range(2))
    got = port.upscale_batch(y, cb, cr, scale, scale)
    want = ref.upscale_batch(y, cb, cr, scale, scale)
    assert [g.shape for g in got] == [(2, h * scale, w * scale), (2, h, w), (2, h, w)]
    for g, w_ in zip(got, want):
        _within_reference_bound(g, w_)


def test_upscale_frames_matches_jax_infer():
    """Mirrors test_infer_pipeline_uint8_roundtrip: u8 RGB in, the full
    forward, quantize(out * 255) out, against the JAX package's
    ``make_infer_fn`` on the same bridged weights, within the
    reference's bound for a conv stack computed in another order
    (measured: 1 of 6,144 bytes one step apart)."""
    config = UpscalerConfig(features=128, depth=2)
    state = port_pipeline.Upscaler(config, seed=3).state_dict()
    tree = to_flax(state, config)
    params = {"params": {m: {k: jnp.asarray(v) for k, v in leaves.items()}
                         for m, leaves in tree["params"].items()}}
    frames = np.random.default_rng(4).integers(0, 256, (2, 16, 16, 3), np.uint8)
    want = np.asarray(jax_infer.make_infer_fn(JaxConfig(features=128, depth=2))(
        params, jnp.asarray(frames)))
    got = port_infer.upscale_frames(state, frames, config, device="cpu")
    assert got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == (2, 32, 32, 3) and got.dtype == np.uint8
    _within_reference_bound(got, want)
    # a torch tensor in gives the same frames out
    again = port_infer.make_infer_fn(config, "cpu")(state, torch.from_numpy(frames))
    np.testing.assert_array_equal(again.numpy(), got)


def test_make_infer_fn_refuses_mesh_and_missing_gpu():
    # a mesh names its own devices: a device beside it is refused
    with pytest.raises(ValueError, match="not both"):
        port_infer.make_infer_fn(UpscalerConfig(), "cpu", mesh=object())
    with pytest.raises(TypeError, match="uint8"):
        port_infer.make_infer_fn(UpscalerConfig(features=8, depth=2), "cpu")(
            port_pipeline.Upscaler(UpscalerConfig(features=8, depth=2)).state_dict(),
            torch.zeros((1, 4, 4, 3)))
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_infer.make_infer_fn(UpscalerConfig())
