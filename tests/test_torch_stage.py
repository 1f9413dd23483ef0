"""The port's ``upscale`` stage and the service around it, on the CPU.

Mirrors of the reference's stage and service tests
(``tests/test_upscale.py``, the compute seam of ``tests/test_faults.py``)
at the reference's test size (features 8, depth 2, batch 4, 16x12 clips),
with ``instance.upscale.device: cpu``; plus what only the port has (the
device knob, no fallback to the CPU, two concurrent jobs on one engine)
and one run of the whole slice against the JAX package's stage on the
same clip and weights.
"""

import asyncio
import base64
import io
import os
import zlib

import numpy as np
import pytest
import torch

from downloader_tpu_torch import schemas
from downloader_tpu_torch.compute.video import (
    Y4MError,
    Y4MHeader,
    Y4MReader,
    Y4MWriter,
    sniff_y4m,
)
from downloader_tpu_torch.platform.config import ConfigNode
from downloader_tpu_torch.platform.logging import NullLogger
from downloader_tpu_torch.stages.base import Job, StageContext, load_stages
from downloader_tpu_torch.utils import EventEmitter

from helpers import start_media_server

pytestmark = pytest.mark.anyio


def make_y4m(width, height, frames, colorspace="420jpeg") -> bytes:
    """Deterministic y4m stream: per-frame gradient planes (the
    reference's test clip)."""
    hdr = Y4MHeader(width=width, height=height, colorspace=colorspace)
    ch, cw = hdr.chroma_shape
    buf = io.BytesIO()
    writer = Y4MWriter(buf, hdr)
    for i in range(frames):
        y = ((np.arange(height * width).reshape(height, width) + i * 7) % 256)
        u = np.full((ch, cw), (64 + i) % 256)
        v = np.full((ch, cw), (192 - i) % 256)
        writer.write_frame(
            y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8)
        )
    return buf.getvalue()


def seeded_y4m(width, height, frames, seed) -> bytes:
    """A seeded random 4:2:0 stream (texture the gradient clip lacks)."""
    hdr = Y4MHeader(width=width, height=height, colorspace="420jpeg")
    ch, cw = hdr.chroma_shape
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    writer = Y4MWriter(buf, hdr)
    for _ in range(frames):
        writer.write_frame(rng.integers(0, 256, (height, width), np.uint8),
                           rng.integers(0, 256, (ch, cw), np.uint8),
                           rng.integers(0, 256, (ch, cw), np.uint8))
    return buf.getvalue()


def _upscale_config(tmp_path, enabled=True, device="cpu", extra=None,
                    instance=None, **upscale_extra):
    upscale = {"enabled": enabled, "features": 8, "depth": 2, "batch": 4,
               **upscale_extra}
    if device is not None:
        upscale["device"] = device
    return ConfigNode({
        "instance": {"download_path": str(tmp_path / "dl"),
                     "upscale": upscale, **(instance or {})},
        **(extra or {}),
    })


def _context(config):
    return StageContext(config=config, emitter=EventEmitter(),
                        logger=NullLogger())


def _job(job_id, files, download_path):
    return Job(
        media=schemas.Media(id=job_id, type=schemas.MediaType.Value("MOVIE")),
        last_stage={"files": [str(f) for f in files],
                    "downloadPath": str(download_path)},
    )


def _download_msg(uri, job_id):
    return schemas.encode(schemas.Download(media=schemas.Media(
        id=job_id, creator_id="card-1", type=schemas.MediaType.Value("MOVIE"),
        source=schemas.SourceType.Value("HTTP"), source_uri=uri)))


def _write_stub(tmp_path, name, body) -> str:
    """An executable python script standing in for ffmpeg."""
    stub = tmp_path / name
    stub.write_text("#!/usr/bin/env python3\n" + body)
    stub.chmod(0o755)
    return str(stub)


def _copy_decoder(tmp_path, fixture) -> str:
    return _write_stub(tmp_path, "stub-decoder", (
        "import sys\n"
        f"with open({str(fixture)!r}, 'rb') as fh:\n"
        "    sys.stdout.buffer.write(fh.read())\n"))


def _zlib_encoder(tmp_path) -> str:
    """Reads the y4m stream off stdin and writes a magic-prefixed zlib
    "container" at the last argv."""
    return _write_stub(tmp_path, "stub-encoder", (
        "import sys, zlib\n"
        "data = sys.stdin.buffer.read()\n"
        "with open(sys.argv[-1], 'wb') as fh:\n"
        "    fh.write(b'STUB!' + zlib.compress(data))\n"))


def _unwrap(blob: bytes) -> bytes:
    assert blob.startswith(b"STUB!"), blob[:16]
    return zlib.decompress(blob[5:])


# ------------------------------------------------------------------ stage

async def test_stage_transforms_y4m_and_passes_through(tmp_path):
    raw = tmp_path / "movie.mkv"
    raw.write_bytes(os.urandom(1024))
    clip = tmp_path / "clip.y4m"
    clip.write_bytes(make_y4m(16, 12, frames=3))
    ctx = _context(_upscale_config(tmp_path))
    table = await load_stages(ctx, ["upscale"])
    job = _job("j1", [raw, clip], tmp_path)
    result = await table["upscale"](job)

    assert result["downloadPath"] == str(tmp_path)
    assert result["files"][0] == str(raw)  # binary passes through untouched
    upscaled = result["files"][1]
    assert upscaled.endswith("clip.2x.y4m")
    header = sniff_y4m(upscaled)
    assert header.width == 32 and header.height == 24

    # the engine is the port's, on the CPU, memoized across jobs
    engine = ctx.resources["upscale.engine"]
    assert type(engine).__module__ == "downloader_tpu_torch.compute.pipeline"
    assert engine.device.type == "cpu" and engine.n_devices == 1
    await table["upscale"](job)
    assert ctx.resources["upscale.engine"] is engine


async def test_stage_removes_partial_output_on_decode_error(tmp_path):
    clip = tmp_path / "clip.y4m"
    clip.write_bytes(make_y4m(16, 12, frames=3)[:-10])
    table = await load_stages(_context(_upscale_config(tmp_path)), ["upscale"])
    with pytest.raises(Y4MError, match="truncated"):
        await table["upscale"](_job("j2", [clip], tmp_path))
    assert not (tmp_path / "clip.2x.y4m").exists()


async def test_decode_front_end_pipes_container_through_model(tmp_path):
    fixture = tmp_path / "decoded.y4m"
    fixture.write_bytes(make_y4m(16, 12, frames=3))
    stub = _copy_decoder(tmp_path, fixture)
    movie = tmp_path / "movie.mkv"
    movie.write_bytes(os.urandom(1024))  # opaque container bytes
    table = await load_stages(_context(_upscale_config(
        tmp_path, decode=True, decoder=stub)), ["upscale"])
    result = await table["upscale"](_job("j3", [movie], tmp_path))

    (upscaled,) = result["files"]
    assert upscaled.endswith("movie.mkv.2x.y4m")
    header = sniff_y4m(upscaled)
    assert header.width == 32 and header.height == 24
    with open(upscaled, "rb") as fh:
        assert len(list(Y4MReader(fh))) == 3


async def test_decode_front_end_missing_decoder_passes_through(tmp_path):
    movie = tmp_path / "movie.mkv"
    movie.write_bytes(os.urandom(512))
    table = await load_stages(_context(_upscale_config(
        tmp_path, decode=True, decoder="no-such-decoder-xyz")), ["upscale"])
    result = await table["upscale"](_job("j4", [movie], tmp_path))
    assert result["files"] == [str(movie)]


async def test_decode_front_end_failure_surfaces_stderr(tmp_path):
    stub = _write_stub(tmp_path, "stub-decoder", (
        "import sys\n"
        "sys.stderr.write('boom: no such codec\\n')\n"
        "sys.exit(3)\n"))
    movie = tmp_path / "movie.mkv"
    movie.write_bytes(os.urandom(512))
    table = await load_stages(_context(_upscale_config(
        tmp_path, decode=True, decoder=stub)), ["upscale"])
    with pytest.raises(RuntimeError, match="boom: no such codec"):
        await table["upscale"](_job("j5", [movie], tmp_path))
    assert not (tmp_path / "movie.mkv.2x.y4m").exists()


async def test_encode_back_end_wraps_output_in_container(tmp_path):
    clip = tmp_path / "clip.y4m"
    clip.write_bytes(make_y4m(16, 12, frames=3))
    table = await load_stages(_context(_upscale_config(
        tmp_path, encode=True, encoder=_zlib_encoder(tmp_path))), ["upscale"])
    result = await table["upscale"](_job("e1", [clip], tmp_path))

    (out,) = result["files"]
    assert out.endswith("clip.y4m.2x.mkv")
    with open(out, "rb") as fh:
        reader = Y4MReader(io.BytesIO(_unwrap(fh.read())))
    assert reader.header.width == 32 and reader.header.height == 24
    assert len(list(reader)) == 3


async def test_decode_encode_compressed_end_to_end(tmp_path):
    fixture = tmp_path / "decoded.y4m"
    fixture.write_bytes(make_y4m(16, 12, frames=5))
    dec = _copy_decoder(tmp_path, fixture)
    enc = _zlib_encoder(tmp_path)
    movie = tmp_path / "movie.mkv"
    movie.write_bytes(os.urandom(1024))
    table = await load_stages(_context(_upscale_config(
        tmp_path, decode=True, decoder=dec, encode=True, encoder=enc,
        container="webm")), ["upscale"])
    result = await table["upscale"](_job("e2", [movie], tmp_path))

    (out,) = result["files"]
    assert out.endswith("movie.mkv.2x.webm")  # container from config
    with open(out, "rb") as fh:
        reader = Y4MReader(io.BytesIO(_unwrap(fh.read())))
    assert reader.header.width == 32 and reader.header.height == 24
    assert len(list(reader)) == 5
    # streaming contract: no intermediate raw y4m anywhere
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".2x.y4m")]


async def test_encode_failure_surfaces_stderr_and_cleans(tmp_path):
    enc = _write_stub(tmp_path, "stub-encoder", (
        "import sys\n"
        "with open(sys.argv[-1], 'wb') as fh:\n"
        "    fh.write(b'partial garbage')\n"
        "sys.stderr.write('encoder blew up: no such codec\\n')\n"
        "sys.exit(4)\n"))
    clip = tmp_path / "clip.y4m"
    clip.write_bytes(make_y4m(16, 12, frames=3))
    table = await load_stages(_context(_upscale_config(
        tmp_path, encode=True, encoder=enc)), ["upscale"])
    with pytest.raises(RuntimeError, match="encoder.*blew up"):
        await table["upscale"](_job("e3", [clip], tmp_path))
    assert not (tmp_path / "clip.y4m.2x.mkv").exists()


async def test_encode_missing_encoder_falls_back_to_raw(tmp_path):
    clip = tmp_path / "clip.y4m"
    clip.write_bytes(make_y4m(16, 12, frames=2))
    table = await load_stages(_context(_upscale_config(
        tmp_path, encode=True, encoder="no-such-encoder-xyz")), ["upscale"])
    result = await table["upscale"](_job("e4", [clip], tmp_path))
    (out,) = result["files"]
    assert out.endswith("clip.2x.y4m")
    header = sniff_y4m(out)
    assert header.width == 32 and header.height == 24


def test_upscale_enabled_gating(tmp_path):
    from downloader_tpu_torch.stages.upscale import upscale_enabled

    assert upscale_enabled(_upscale_config(tmp_path))
    assert not upscale_enabled(_upscale_config(tmp_path, enabled=False))
    assert not upscale_enabled(ConfigNode({"instance": {}}))
    assert not upscale_enabled(ConfigNode({}))


def test_build_service_inserts_stage(tmp_path):
    from downloader_tpu_torch.app import build_service

    orchestrator, _m, _t = build_service(_upscale_config(tmp_path))
    assert orchestrator.stage_names == ["download", "process", "upscale",
                                        "upload"]
    plain, _m2, _t2 = build_service(
        ConfigNode({"instance": {"download_path": str(tmp_path / "d2")}}))
    assert plain.stage_names == ["download", "process", "upload"]


# ------------------------------------------------------ the port's knobs

def test_engine_knobs_read_as_documented(tmp_path):
    from downloader_tpu_torch.stages.upscale import _engine_config

    opts = _engine_config(_upscale_config(tmp_path, device=None))
    assert opts["device"] == "cuda"  # the card unless the CPU is asked for
    assert opts["use_mesh"] is True and opts["donate"] is False
    opts = _engine_config(_upscale_config(tmp_path, use_mesh=False,
                                          donate=True))
    assert (opts["device"], opts["use_mesh"], opts["donate"]) == (
        "cpu", False, True)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        _engine_config(_upscale_config(tmp_path, device="tpu"))


async def test_bad_device_fails_the_stage_load(tmp_path):
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        await load_stages(_context(_upscale_config(tmp_path, device="cuda:1x")),
                          ["upscale"])


async def test_stage_without_a_card_fails_through_the_compute_seam(
        tmp_path, monkeypatch):
    """No fallback hides the card: without one and without ``device:
    cpu`` the engine raises inside the ``compute.upscale`` seam, so the
    compute breaker records the failure and no engine is memoized."""
    from downloader_tpu_torch.platform.errors import Retrier

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clip = tmp_path / "clip.y4m"
    clip.write_bytes(make_y4m(16, 12, frames=2))
    ctx = _context(_upscale_config(tmp_path, device=None, extra={
        "retry": {"compute": {"attempts": 2, "base": 0.001, "cap": 0.002}},
        "breakers": {"compute": {"threshold": 2, "reset": 30}},
    }))
    table = await load_stages(ctx, ["upscale"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        await table["upscale"](_job("nocard", [clip], tmp_path))
    assert "upscale.engine" not in ctx.resources
    assert not (tmp_path / "clip.2x.y4m").exists()
    breaker = Retrier.shared(ctx.resources, ctx.config).breakers.get("compute")
    assert breaker.state == "open" and breaker.open_reason == "failure"


async def test_orbax_checkpoint_is_refused_by_name(tmp_path):
    ckpt = tmp_path / "orbax" / "4"
    (ckpt / "params").mkdir(parents=True)
    (ckpt / "_CHECKPOINT_METADATA").write_text("{}")
    clip = tmp_path / "clip.y4m"
    clip.write_bytes(make_y4m(16, 12, frames=2))
    table = await load_stages(_context(_upscale_config(
        tmp_path, checkpoint=str(tmp_path / "orbax"))), ["upscale"])
    with pytest.raises(ValueError, match="orbax"):
        await table["upscale"](_job("orbax", [clip], tmp_path))


def test_port_package_installs_compat_backports():
    """As the reference's package does at import: importing the port puts
    the ``asyncio.timeout`` backport in place on a runtime without one
    (checked in a fresh interpreter with ``asyncio.timeout`` removed)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    probe = ("import asyncio\n"
             "del asyncio.timeout\n"
             "import downloader_tpu_torch\n"
             "print(asyncio.timeout.__module__)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["downloader_tpu_torch.utils.compat"]


# ------------------------------------------------------- full pipeline

async def _run_job(orchestrator, broker, uri, job_id):
    broker.publish(schemas.DOWNLOAD_QUEUE, _download_msg(uri, job_id))
    await broker.join(schemas.DOWNLOAD_QUEUE, timeout=60)


async def test_pipeline_end_to_end_with_upscale(tmp_path):
    """http download of a .y4m -> process -> upscale on the port's engine
    -> upload; the staged object is the upscaled stream, and the job's
    hop ledger holds the engine's hops, the stream's read and write
    among them."""
    from downloader_tpu_torch.mq import InMemoryBroker, MemoryQueue
    from downloader_tpu_torch.orchestrator import Orchestrator
    from downloader_tpu_torch.store import InMemoryObjectStore

    clip = make_y4m(16, 12, frames=5)
    media_srv, base = await start_media_server(clip, path="/clip.y4m")
    broker = InMemoryBroker(max_redeliveries=3)
    store = InMemoryObjectStore()
    orchestrator = Orchestrator(
        config=_upscale_config(tmp_path), mq=MemoryQueue(broker), store=store,
        logger=NullLogger(),
        stages=["download", "process", "upscale", "upload"])
    await orchestrator.start()
    try:
        await _run_job(orchestrator, broker, f"{base}/clip.y4m", "up-1")
        assert len(broker.published(schemas.CONVERT_QUEUE)) == 1
        name = "up-1/original/" + base64.b64encode(b"clip.2x.y4m").decode()
        staged = await store.get_object("triton-staging", name)
        reader = Y4MReader(io.BytesIO(staged))
        assert reader.header.width == 32 and reader.header.height == 24
        assert len(list(reader)) == 5
        await store.get_object("triton-staging", "up-1/original/done")

        engine = orchestrator.stage_resources["upscale.engine"]
        assert engine.n_devices == 1  # use_mesh on the CPU: one device
        record = orchestrator.registry.get("up-1")
        assert record.state == "DONE" and record.workload == "UPSCALE"
        hops = record.hops.summary()
        for hop in ("read", "h2d", "compute", "d2h", "write"):
            assert hops[hop]["bytes"] > 0, hops
    finally:
        await orchestrator.shutdown(grace_seconds=5)
        await media_srv.cleanup()


async def test_pipeline_end_to_end_with_encode(tmp_path):
    """download -> upscale -> encode -> upload through ``build_service``,
    with the production metrics of the transcode."""
    from downloader_tpu_torch.app import build_service
    from downloader_tpu_torch.mq import InMemoryBroker
    from downloader_tpu_torch.store import InMemoryObjectStore

    stub = _zlib_encoder(tmp_path)
    clip = make_y4m(16, 12, frames=4)
    media_srv, base = await start_media_server(clip, path="/clip.y4m")
    broker = InMemoryBroker(max_redeliveries=3)
    store = InMemoryObjectStore()
    orchestrator, metrics, _telemetry = build_service(
        _upscale_config(tmp_path, encode=True, encoder=stub), broker, store)
    await orchestrator.start()
    try:
        await _run_job(orchestrator, broker, f"{base}/clip.y4m", "enc-1")
        assert len(broker.published(schemas.CONVERT_QUEUE)) == 1
        name = "enc-1/original/" + base64.b64encode(b"clip.y4m.2x.mkv").decode()
        staged = await store.get_object("triton-staging", name)
        reader = Y4MReader(io.BytesIO(_unwrap(staged)))
        assert reader.header.width == 32 and reader.header.height == 24
        assert len(list(reader)) == 4
        await store.get_object("triton-staging", "enc-1/original/done")
        assert metrics.transcode_bytes_in._value.get() == len(clip)
        assert metrics.transcode_bytes_out._value.get() == len(staged)
        assert metrics.frames_upscaled._value.get() == 4
    finally:
        await orchestrator.shutdown(grace_seconds=5)
        await media_srv.cleanup()


async def test_two_concurrent_jobs_share_one_engine(tmp_path):
    """Two jobs at once (``max_concurrent_jobs: 2``) on the one memoized
    engine: each staged stream is byte-identical to that engine's
    ``upscale_to`` of its clip, each job's ledger holds its own hops, and
    ``frames_upscaled`` counts both jobs' frames."""
    from aiohttp import web

    from downloader_tpu_torch.app import build_service
    from downloader_tpu_torch.mq import InMemoryBroker
    from downloader_tpu_torch.store.fs import FilesystemObjectStore

    from helpers import start_http_server

    clips = {"a": seeded_y4m(32, 24, 8, seed=1),
             "b": seeded_y4m(32, 24, 8, seed=2)}

    async def serve(request):
        return web.Response(body=clips[request.match_info["name"]])

    runner, base = await start_http_server(serve, path="/{name}/clip.y4m")
    broker = InMemoryBroker(max_redeliveries=3)
    store = FilesystemObjectStore(str(tmp_path / "store"))
    config = _upscale_config(tmp_path, instance={"max_concurrent_jobs": 2})
    orchestrator, metrics, _t = build_service(config, broker, store)
    await orchestrator.start()
    try:
        for name in clips:
            broker.publish(schemas.DOWNLOAD_QUEUE,
                           _download_msg(f"{base}/{name}/clip.y4m", f"job-{name}"))
        await broker.join(schemas.DOWNLOAD_QUEUE, timeout=60)
        assert len(broker.published(schemas.CONVERT_QUEUE)) == 2
        engine = orchestrator.stage_resources["upscale.engine"]
        staged_name = base64.b64encode(b"clip.2x.y4m").decode()
        for name, clip in clips.items():
            staged = await store.get_object(
                "triton-staging", f"job-{name}/original/{staged_name}")
            want = io.BytesIO()
            engine.upscale_to(io.BytesIO(clip), want)
            assert staged == want.getvalue(), name
            await store.get_object("triton-staging", f"job-{name}/original/done")
            hops = orchestrator.registry.get(f"job-{name}").hops.summary()
            assert {"h2d", "compute", "d2h"} <= set(hops), hops
        assert metrics.frames_upscaled._value.get() == 16
    finally:
        await orchestrator.shutdown(grace_seconds=5)
        await runner.cleanup()


async def test_compute_seam_fault_opens_compute_breaker(tmp_path):
    """Faulting ``compute.upscale`` opens the compute breaker (visible on
    /readyz and /metrics) while the replica stays ready; the job rides its
    UPSCALE SLO class to completion once the seam heals, and its ledger
    holds the engine's hops."""
    import aiohttp
    from aiohttp import web

    from downloader_tpu_torch.health import build_app
    from downloader_tpu_torch.mq import InMemoryBroker, MemoryQueue
    from downloader_tpu_torch.orchestrator import Orchestrator
    from downloader_tpu_torch.platform import faults
    from downloader_tpu_torch.platform import metrics as prom
    from downloader_tpu_torch.platform.telemetry import Telemetry
    from downloader_tpu_torch.store import InMemoryObjectStore

    runner, base = await start_media_server(make_y4m(16, 12, frames=2),
                                            path="/clip.y4m")
    broker = InMemoryBroker()
    store = InMemoryObjectStore()
    config = _upscale_config(tmp_path, extra={
        "retry": {
            "default": {"attempts": 3, "base": 0.01, "cap": 0.05},
            # one try per delivery -> each delivery records exactly one
            # compute-breaker failure; threshold 2 opens on the second
            "compute": {"attempts": 1, "base": 0.01, "cap": 0.02},
            "redelivery": {"base": 0.02, "cap": 0.1},
        },
        "breakers": {
            "default": {"threshold": 50, "reset": 0.5},
            "compute": {"threshold": 2, "reset": 0.4},
        },
        "faults": {"plan": [
            {"seam": "compute.upscale", "kind": "error", "count": 2},
        ]},
    })
    telem_mq = MemoryQueue(broker)
    await telem_mq.connect()
    orchestrator = Orchestrator(
        config=config, mq=MemoryQueue(broker), store=store,
        telemetry=Telemetry(telem_mq),
        metrics=prom.new(f"torchchaos{os.urandom(4).hex()}"),
        logger=NullLogger(),
        stages=["download", "process", "upscale", "upload"])
    await orchestrator.start()
    admin = web.AppRunner(build_app(orchestrator, orchestrator.metrics))
    await admin.setup()
    site = web.TCPSite(admin, "127.0.0.1", 0)
    await site.start()
    api = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
    session = aiohttp.ClientSession()
    try:
        broker.publish(schemas.DOWNLOAD_QUEUE,
                       _download_msg(f"{base}/clip.y4m", "job-cmp"))
        breaker = orchestrator.breakers.get("compute")
        async with asyncio.timeout(30):
            while breaker.state != "open":
                await asyncio.sleep(0.01)
        assert breaker.open_reason == "failure"

        async with session.get(f"{api}/readyz") as resp:
            assert resp.status == 200
            body = await resp.json()
            assert body["breakers"]["compute"] == "open"
            assert body["breakerReasons"]["compute"] == "failure"
            assert "UPSCALE" in body["slo"]["objectives"]
        async with session.get(f"{api}/metrics") as resp:
            text = await resp.text()
        assert 'breaker_state{dependency="compute"} 1.0' in text
        assert ('breaker_opened_total{dependency="compute",'
                'reason="failure"}') in text
        assert 'slo_burn_rate{class="UPSCALE",window="fast"}' in text

        await broker.join(schemas.DOWNLOAD_QUEUE, timeout=30)
        record = orchestrator.registry.get("job-cmp")
        assert record.state == "DONE"
        assert record.workload == "UPSCALE"
        assert breaker.state == "closed"
        hops = record.hops.summary()
        assert {"h2d", "compute", "d2h"} <= set(hops), hops
    finally:
        await session.close()
        await admin.cleanup()
        await orchestrator.shutdown(grace_seconds=5)
        await runner.cleanup()
        assert faults.active() is None, "the orchestrator left its fault plan"


# ------------------------------------------ the slice against the JAX package

async def test_service_matches_jax_service_end_to_end(tmp_path):
    """The same seeded clip through the reference's service graph (its
    stage on the JAX engine) and through the port's, on the same weights:
    the JAX engine's params, bridged by ``weights.from_flax`` into a port
    checkpoint that ``instance.upscale.checkpoint`` names.  The staged
    streams agree within the reference's own bound for its conv stack:
    <= 1 u8 step and > 97% exact (tests/test_upscale.py)."""
    import jax

    from downloader_tpu import schemas as ref_schemas
    from downloader_tpu.mq import InMemoryBroker as RefBroker
    from downloader_tpu.mq import MemoryQueue as RefQueue
    from downloader_tpu.orchestrator import Orchestrator as RefOrchestrator
    from downloader_tpu.platform.config import ConfigNode as RefConfig
    from downloader_tpu.platform.logging import NullLogger as RefNullLogger
    from downloader_tpu.store import InMemoryObjectStore as RefStore
    from downloader_tpu_torch.compute.checkpoint import save_state
    from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
    from downloader_tpu_torch.compute.weights import from_flax
    from downloader_tpu_torch.mq import InMemoryBroker, MemoryQueue
    from downloader_tpu_torch.orchestrator import Orchestrator
    from downloader_tpu_torch.store import InMemoryObjectStore

    clip = seeded_y4m(32, 24, 6, seed=5)
    media_srv, base = await start_media_server(clip, path="/clip.y4m")
    staged_name = "up-1/original/" + base64.b64encode(b"clip.2x.y4m").decode()
    stages = ["download", "process", "upscale", "upload"]
    try:
        broker, store = RefBroker(max_redeliveries=3), RefStore()
        ref = RefOrchestrator(
            config=RefConfig({"instance": {
                "download_path": str(tmp_path / "ref"),
                "upscale": {"enabled": True, "features": 8, "depth": 2,
                            "batch": 4}}}),
            mq=RefQueue(broker), store=store, logger=RefNullLogger(),
            stages=stages)
        await ref.start()
        try:
            broker.publish(ref_schemas.DOWNLOAD_QUEUE, ref_schemas.encode(
                ref_schemas.Download(media=ref_schemas.Media(
                    id="up-1", creator_id="card-1",
                    type=ref_schemas.MediaType.Value("MOVIE"),
                    source=ref_schemas.SourceType.Value("HTTP"),
                    source_uri=f"{base}/clip.y4m"))))
            await broker.join(ref_schemas.DOWNLOAD_QUEUE, timeout=120)
            want = await store.get_object("triton-staging", staged_name)
            params = jax.tree_util.tree_map(
                np.asarray, ref.stage_resources["upscale.engine"].params)
        finally:
            await ref.shutdown(grace_seconds=5)

        ckpt = tmp_path / "ckpt"
        save_state(str(ckpt), 1,
                   from_flax(params, UpscalerConfig(features=8, depth=2)), {})
        broker, store = InMemoryBroker(max_redeliveries=3), InMemoryObjectStore()
        port = Orchestrator(
            config=_upscale_config(tmp_path, checkpoint=str(ckpt)),
            mq=MemoryQueue(broker), store=store, logger=NullLogger(),
            stages=stages)
        await port.start()
        try:
            await _run_job(port, broker, f"{base}/clip.y4m", "up-1")
            got = await store.get_object("triton-staging", staged_name)
        finally:
            await port.shutdown(grace_seconds=5)
    finally:
        await media_srv.cleanup()

    got_reader, want_reader = Y4MReader(io.BytesIO(got)), Y4MReader(io.BytesIO(want))
    assert got_reader.header == want_reader.header
    got_frames, want_frames = list(got_reader), list(want_reader)
    assert len(got_frames) == len(want_frames) == 6
    for g_frame, w_frame in zip(got_frames, want_frames):
        for g, w in zip(g_frame, w_frame):
            diff = np.abs(g.astype(int) - w.astype(int))
            assert diff.max() <= 1, diff.max()
            assert (diff == 0).mean() > 0.97, (diff == 0).mean()
