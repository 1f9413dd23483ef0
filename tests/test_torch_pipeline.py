"""The port's frame engine and ``upscale`` CLI, on the CPU, held against
the JAX package's engine on the same (bridged) weights."""

import io
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from downloader_tpu.compute.models.upscaler import UpscalerConfig as JaxConfig
from downloader_tpu.compute.pipeline import FrameUpscaler as JaxUpscaler
from downloader_tpu_torch import resolve_device
from downloader_tpu_torch.cli import main as cli_main
from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
from downloader_tpu_torch.compute.pipeline import FrameUpscaler
from downloader_tpu_torch.compute.video import Y4MHeader, Y4MReader, Y4MWriter
from downloader_tpu_torch.compute.weights import from_flax, to_flax

TINY = UpscalerConfig(features=8, depth=2)


def _y4m(width, height, frames, colorspace="420jpeg", seed=0) -> bytes:
    """A seeded random Y4M stream."""
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


def _planes(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, h, w), np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), np.uint8))


@pytest.fixture(scope="module")
def engines():
    """One JAX engine (its flax init costs seconds, so it is built once)
    and a port engine carrying the same weights, bridged from the port's
    seeded init."""
    port = FrameUpscaler(TINY, batch=4, seed=7, device="cpu")
    ref = JaxUpscaler(config=JaxConfig(features=8, depth=2), batch=4,
                      use_mesh=False)
    tree = to_flax(port.model.state_dict(), TINY)
    ref.params = {"params": {m: {k: jnp.asarray(v) for k, v in leaves.items()}
                             for m, leaves in tree["params"].items()}}
    return port, ref


def test_upscale_batch_matches_jax_engine(engines):
    """Within the reference's own bound for its s2d path (<=1 u8 step,
    >97% exact; tests/test_upscale.py).  Measured here: byte-exact on all
    three planes — the convs and the tail match bit for bit, and the
    <=2-ulp YCbCr->RGB difference vanishes in the cast to bf16."""
    port, ref = engines
    y, cb, cr = _planes(4, 12, 16, seed=11)
    got = port.upscale_batch(y, cb, cr, 2, 2)
    want = ref.upscale_batch(y, cb, cr, 2, 2)
    for g, w, shape in zip(got, want, [(4, 24, 32), (4, 12, 16), (4, 12, 16)]):
        w = np.asarray(w)
        assert g.shape == w.shape == shape and g.dtype == np.uint8
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1, diff.max()
        assert (diff == 0).mean() > 0.97, (diff == 0).mean()
        np.testing.assert_array_equal(g, w)  # the measured figure


def test_short_and_chunked_batches_match(engines):
    """Any n: a short batch runs at its own size, an oversize one is
    chunked through the transfer queue — outputs are identical."""
    port, _ = engines
    y, cb, cr = _planes(6, 12, 16, seed=12)
    whole = port.upscale_batch(y, cb, cr, 2, 2)   # 4 + 2 through the queue
    first = port.upscale_batch(y[:3], cb[:3], cr[:3], 2, 2)
    rest = port.upscale_batch(y[3:], cb[3:], cr[3:], 2, 2)
    for plane in range(3):
        assert whole[plane].shape[0] == 6
        np.testing.assert_array_equal(
            whole[plane], np.concatenate([first[plane], rest[plane]]))


def test_batch_for_caps_by_resolution():
    """Mirrors the reference's test: the pixel budget (kept from the
    reference, 8 x 1080p) caps the dispatch batch."""
    engine = FrameUpscaler(TINY, batch=8, device="cpu")
    assert engine.PIXEL_BUDGET == 8 * 1920 * 1080
    assert engine.batch_for(720, 1280) == 8
    assert engine.batch_for(1080, 1920) == 8
    assert engine.batch_for(2160, 3840) == 2
    assert engine.batch_for(16, 16) == 8
    engine.PIXEL_BUDGET = 1
    assert engine.batch_for(2160, 3840) == engine.n_devices == 1


def test_upscale_y4m_respects_pixel_budget(tmp_path):
    engine = FrameUpscaler(TINY, batch=4, device="cpu")
    src = tmp_path / "clip.y4m"
    src.write_bytes(_y4m(16, 12, 5, seed=3))
    full = tmp_path / "full.y4m"
    assert engine.upscale_y4m(str(src), str(full)) == 5
    engine.PIXEL_BUDGET = 16 * 12 * 2  # two frames per dispatch
    capped = tmp_path / "capped.y4m"
    assert engine.upscale_y4m(str(src), str(capped)) == 5
    assert full.read_bytes() == capped.read_bytes()


def test_cli_upscale_on_cpu_matches_engine(tmp_path, capsys):
    src = tmp_path / "clip.y4m"
    src.write_bytes(_y4m(16, 12, 3, seed=4))
    dst = tmp_path / "clip.2x.y4m"
    assert cli_main(["upscale", str(src), str(dst), "--batch", "2",
                     "--device", "cpu"]) == 0
    assert "upscaled 3 frames" in capsys.readouterr().out
    with open(src, "rb") as fh:
        frames = list(Y4MReader(fh))
    with open(dst, "rb") as fh:
        reader = Y4MReader(fh)
        assert (reader.header.width, reader.header.height) == (32, 24)
        assert reader.header.colorspace == "420jpeg"
        out = list(reader)
    assert len(out) == 3
    # the CLI's engine: default (shipping-width) config, seed 0
    engine = FrameUpscaler(batch=2, device="cpu")
    want = engine.upscale_batch(*(np.stack(p) for p in zip(*frames)), 2, 2)
    for i, planes in enumerate(out):
        for plane, got in enumerate(planes):
            np.testing.assert_array_equal(got, want[plane][i])


def test_default_device_is_cuda_and_never_falls_back():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrameUpscaler(TINY)


@pytest.mark.parametrize("flag", [True, False])
def test_engine_leaves_process_tf32_flags_alone(engines, flag):
    """The engine computes without TF32 but restores the process-wide
    flags for other torch code, whatever they were."""
    port, _ = engines
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = flag
        torch.backends.cuda.matmul.allow_tf32 = flag
        FrameUpscaler(TINY, batch=2, device="cpu")
        port.upscale_batch(*_planes(1, 12, 16, seed=14), 2, 2)
        assert torch.backends.cudnn.allow_tf32 is flag
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_params_round_trip_through_engine(engines):
    port, _ = engines
    state = from_flax(to_flax(port.model.state_dict(), TINY), TINY)
    other = FrameUpscaler(TINY, batch=4, params=state, seed=99, device="cpu")
    y, cb, cr = _planes(2, 12, 16, seed=13)
    for a, b in zip(port.upscale_batch(y, cb, cr, 2, 2),
                    other.upscale_batch(y, cb, cr, 2, 2)):
        np.testing.assert_array_equal(a, b)


def _stub(tmp_path, name: str, body: str) -> str:
    """An executable python script standing in for ffmpeg."""
    path = tmp_path / name
    path.write_text("#!/usr/bin/env python3\nimport sys, zlib\n" + body)
    path.chmod(0o755)
    return str(path)


def test_cli_decode_encode_round_trip(tmp_path):
    """The copied transcode end to end: a decoder stub emits the Y4M, the
    engine upscales it, an encoder stub wraps the stream into a
    "container" at dst — the wrapped stream is exactly the plain
    ``upscale`` output of the same Y4M."""
    raw = tmp_path / "decoded.y4m"
    raw.write_bytes(_y4m(16, 12, 3, seed=6))
    dec = _stub(tmp_path, "stub-decoder",
                f"sys.stdout.buffer.write(open({str(raw)!r}, 'rb').read())\n")
    enc = _stub(tmp_path, "stub-encoder",
                "data = sys.stdin.buffer.read()\n"
                "open(sys.argv[-1], 'wb').write(b'STUB!' + zlib.compress(data))\n")
    movie = tmp_path / "movie.mkv"
    movie.write_bytes(b"opaque container bytes")
    out = tmp_path / "movie.2x.mkv"
    assert cli_main(["upscale", str(movie), str(out), "--device", "cpu",
                     "--decoder", dec, "--encoder", enc]) == 0
    blob = out.read_bytes()
    assert blob.startswith(b"STUB!")
    plain = tmp_path / "plain.y4m"
    assert cli_main(["upscale", str(raw), str(plain), "--device", "cpu"]) == 0
    assert zlib.decompress(blob[5:]) == plain.read_bytes()


def test_cli_encoder_failure_leaves_no_dst(tmp_path, capsys):
    src = tmp_path / "clip.y4m"
    src.write_bytes(_y4m(16, 12, 2, seed=7))
    enc = _stub(tmp_path, "stub-encoder",
                "sys.stdin.buffer.read()\n"
                "sys.stderr.write('boom: no such codec')\n"
                "sys.exit(3)\n")
    dst = tmp_path / "out.mkv"
    assert cli_main(["upscale", str(src), str(dst), "--device", "cpu",
                     "--encoder", enc]) == 1
    assert "boom: no such codec" in capsys.readouterr().err
    assert not dst.exists()
    assert not [p for p in os.listdir(tmp_path) if ".part-" in p]
