"""The port's hop billing (``compute/parallel/transfer.py``) on the
engine's and the trainer's host threads, on the CPU but where marked.

``timed_hop`` notes a hop while a sink is bound on the thread and marks
it on the torch profiler's timeline as ``host.<layer>.<hop>`` while a
profiler records; with neither it reads no clock.  The engine bills
``read``, ``h2d``, ``compute``, ``d2h`` and ``write`` per batch (on CUDA
``launch`` and ``device`` too); the trainer bills ``read`` and
``to_rgb`` per crop, ``downsample``, ``h2d`` and ``launch`` per step and
``loss_read`` at log steps, and sums them into its summary's ``host_s``.

The engine hands its sink each frame's planes as 1-D byte views of its
output rows, with no host copy; on the card the d2h copies run on a
download stream of their own, beside the next batch's compute.
"""

import io
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from downloader_tpu_torch.cli import main as cli_main
from downloader_tpu_torch.compute import pipeline, trainer
from downloader_tpu_torch.compute.models.upscaler import UpscalerConfig
from downloader_tpu_torch.compute.parallel import transfer
from downloader_tpu_torch.compute.parallel.transfer import (
    HopSink,
    timed_hop,
    timed_next,
)
from downloader_tpu_torch.compute.pipeline import FrameUpscaler
from downloader_tpu_torch.compute.video import Y4MError, Y4MHeader, Y4MReader, Y4MWriter

TINY = UpscalerConfig(features=8, depth=2)
ENGINE_HOPS = ("read", "h2d", "launch", "compute", "d2h", "write")
TRAINER_HOPS = {"read", "to_rgb", "downsample", "h2d", "launch", "loss_read"}


def _clip(width, height, frames, seed=0, colorspace="420jpeg") -> bytes:
    """A seeded Y4M stream (4:2:0 unless ``colorspace`` says otherwise)."""
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    hdr = Y4MHeader(width=width, height=height, colorspace=colorspace)
    writer = Y4MWriter(buf, hdr)
    for _ in range(frames):
        writer.write_frame(rng.integers(0, 256, (height, width), np.uint8),
                           rng.integers(0, 256, hdr.chroma_shape, np.uint8),
                           rng.integers(0, 256, hdr.chroma_shape, np.uint8))
    return buf.getvalue()


def _ranges(prof, prefix: str) -> Counter:
    """How often each profiler range named ``prefix...`` was opened."""
    return Counter(e.name for e in prof.events() if e.name.startswith(prefix))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_timed_hop_opens_a_range_only_while_a_profiler_records():
    engine, trainer_sink = HopSink("engine"), HopSink("trainer")
    with timed_hop(engine, "h2d", 8):
        pass
    with _cpu_profile() as prof:
        with timed_hop(engine, "h2d", 8):
            pass
        with timed_hop(trainer_sink, "to_rgb", 8):
            pass
        with timed_hop(None, "h2d", 8):
            pass
    assert _ranges(prof, "host.") == {"host.engine.h2d": 1, "host.trainer.to_rgb": 1}


def test_timed_hop_notes_only_while_bound():
    sink = HopSink("engine")
    got = []
    with _cpu_profile():
        with timed_hop(sink, "h2d", 8):
            pass
    with sink.bound(lambda hop, n, s: got.append((hop, n, s))):
        assert sink.is_bound()
        with timed_hop(sink, "h2d", 8):
            pass
        with timed_hop(sink, "read") as billed:
            billed.nbytes = 21
    assert not sink.is_bound()
    assert [(hop, n) for hop, n, _ in got] == [("h2d", 8), ("read", 21)]
    assert all(s >= 0 for _, _, s in got)


def test_timed_hop_reads_no_clock_with_neither(monkeypatch):
    """Unbound and unprofiled, a hop reads no clock and builds no range:
    both would raise here."""
    def refuse(*_args):
        raise AssertionError("timed_hop touched the clock or the profiler")

    monkeypatch.setattr(transfer.time, "monotonic", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    sink = HopSink("engine")
    with timed_hop(sink, "h2d", 8) as billed:
        billed.nbytes = 9
    with timed_hop(None, "h2d", 8):
        pass
    assert timed_next(sink, "read", iter([(np.zeros(2),)]))[0].shape == (2,)


def test_timed_next_bills_the_items_bytes_and_the_end():
    sink = HopSink("engine")
    got = []
    items = iter([(np.zeros(3, np.uint8), np.zeros((2, 2), np.uint16))])
    with sink.bound(lambda hop, n, s: got.append((hop, n))):
        first = timed_next(sink, "read", items)
        assert timed_next(sink, "read", items) is None
    assert len(first) == 2
    assert got == [("read", 3 + 8), ("read", 0)]


def test_upscale_to_bills_read_and_write_once_per_batch():
    """Seven frames at batch 3: three batches, the last short; each is
    read, staged, computed, fetched and written once, and the read that
    finds the stream's end is billed with no bytes."""
    engine = FrameUpscaler(TINY, batch=3, device="cpu")
    got = []
    with engine.hop_sink.bound(lambda hop, n, s: got.append((hop, n))):
        assert engine.upscale_to(io.BytesIO(_clip(16, 12, 7)), io.BytesIO()) == 7
    frame_in, frame_out = 16 * 12 * 3 // 2, 32 * 24 * 3 // 2
    billed = {hop: [n for h, n in got if h == hop] for hop, _ in got}
    assert set(billed) == {"read", "h2d", "compute", "d2h", "write"}
    assert billed["read"] == [3 * frame_in, 3 * frame_in, frame_in, 0]
    assert billed["write"] == [3 * frame_out, 3 * frame_out, frame_out]
    for hop in ("h2d", "compute", "d2h"):
        assert len(billed[hop]) == 3, hop


def test_upscale_to_marks_every_hop_on_the_profiler_once_per_batch():
    engine = FrameUpscaler(TINY, batch=3, device="cpu")
    with _cpu_profile() as prof:
        engine.upscale_to(io.BytesIO(_clip(16, 12, 7)), io.BytesIO())
    assert _ranges(prof, "host.") == {
        "host.engine.read": 4, "host.engine.h2d": 3, "host.engine.compute": 3,
        "host.engine.d2h": 3, "host.engine.write": 3}


def test_upscale_to_output_is_unchanged_by_billing():
    engine = FrameUpscaler(TINY, batch=3, device="cpu", seed=4)
    clip = _clip(16, 12, 5, seed=2)
    plain, billed = io.BytesIO(), io.BytesIO()
    engine.upscale_to(io.BytesIO(clip), plain)
    with _cpu_profile(), engine.hop_sink.bound(lambda *_: None):
        engine.upscale_to(io.BytesIO(clip), billed)
    assert billed.getvalue() == plain.getvalue()


COLORSPACES = ("420jpeg", "422", "444")


class _Keeper:
    """A sink that keeps every object it is given, beside a copy of its
    bytes taken when it was given."""

    def __init__(self):
        self.kept = []
        self.copies = []

    def write(self, data) -> int:
        self.kept.append(data)
        self.copies.append(bytes(data))
        return len(data)


def _writers_bytes(engine, clip: bytes) -> bytes:
    """The stream ``Y4MWriter.write_frame`` makes of the engine's planes,
    batch by batch as ``upscale_to`` cuts them."""
    reader = Y4MReader(io.BytesIO(clip))
    hdr = reader.header
    out = io.BytesIO()
    writer = Y4MWriter(out, hdr.scaled(engine.config.scale))
    for planes in pipeline._batched(iter(reader), engine.batch_for(hdr.height, hdr.width)):
        y2, cb2, cr2 = engine.upscale_batch(*planes, *hdr.subsampling)
        for i in range(y2.shape[0]):
            writer.write_frame(y2[i], cb2[i], cr2[i])
    return out.getvalue()


@pytest.mark.parametrize("colorspace", COLORSPACES)
def test_upscale_to_writes_the_writers_bytes(colorspace):
    """Seven frames at batch 3 (the last batch short): the stream written
    from the views is byte for byte the one ``Y4MWriter`` writes."""
    engine = FrameUpscaler(TINY, batch=3, device="cpu", seed=5)
    clip = _clip(16, 12, 7, seed=3, colorspace=colorspace)
    out = io.BytesIO()
    assert engine.upscale_to(io.BytesIO(clip), out) == 7
    assert out.getvalue() == _writers_bytes(engine, clip)


@pytest.mark.parametrize("colorspace", COLORSPACES)
def test_upscale_to_hands_the_sink_one_flat_buffer_per_plane(colorspace):
    """After the header, each frame is its marker and three 1-D byte
    buffers whose ``len()`` is the plane's bytes."""
    engine = FrameUpscaler(TINY, batch=3, device="cpu")
    sink = _Keeper()
    engine.upscale_to(io.BytesIO(_clip(16, 12, 7, colorspace=colorspace)), sink)
    out_hdr = Y4MHeader(width=32, height=24, colorspace=colorspace)
    ch, cw = out_hdr.chroma_shape
    assert sink.copies[0] == out_hdr.encode()
    records = sink.kept[1:]
    assert len(records) == 7 * 4
    for f in range(7):
        marker, *planes = records[4 * f:4 * f + 4]
        assert bytes(marker) == b"FRAME\n"
        for data, size in zip(planes, (32 * 24, ch * cw, ch * cw)):
            view = memoryview(data)
            assert (view.ndim, view.itemsize, view.nbytes) == (1, 1, size)
            assert len(data) == size


@pytest.mark.parametrize("depth", [1, 3])
def test_a_sink_may_keep_what_it_is_given(depth):
    """A sink that keeps every object finds each kept frame unchanged
    after every later batch has been written."""
    engine = FrameUpscaler(TINY, batch=2, device="cpu", seed=6)
    clip = _clip(16, 12, 9, seed=8)
    sink = _Keeper()
    engine.upscale_to(io.BytesIO(clip), sink, depth=depth)
    assert [bytes(data) for data in sink.kept] == sink.copies
    assert b"".join(sink.kept) == _writers_bytes(engine, clip)


@pytest.mark.parametrize("colorspace", ["422", "444"])
def test_upscale_to_bills_write_once_per_batch_with_the_planes_bytes(colorspace):
    engine = FrameUpscaler(TINY, batch=3, device="cpu")
    got = []
    with engine.hop_sink.bound(lambda hop, n, s: got.append((hop, n))):
        engine.upscale_to(io.BytesIO(_clip(16, 12, 7, colorspace=colorspace)),
                          io.BytesIO())
    ch, cw = Y4MHeader(width=32, height=24, colorspace=colorspace).chroma_shape
    frame_out = 32 * 24 + 2 * ch * cw
    assert [n for hop, n in got if hop == "write"] == [
        3 * frame_out, 3 * frame_out, frame_out]


def test_upscale_to_refuses_planes_that_do_not_match_the_header(monkeypatch):
    """The writer's check holds: planes of another shape raise before
    any of the frame is written."""
    engine = FrameUpscaler(TINY, batch=3, device="cpu")
    fetch = engine._fetch

    def cropped(handle):
        return tuple(p[:, :-2] for p in fetch(handle))

    monkeypatch.setattr(engine, "_fetch", cropped)
    sink = _Keeper()
    with pytest.raises(Y4MError, match="do not match header 32x24"):
        engine.upscale_to(io.BytesIO(_clip(16, 12, 4)), sink)
    assert sink.copies == [Y4MHeader(width=32, height=24).encode()]


@pytest.fixture
def media(tmp_path):
    path = tmp_path / "clip.y4m"
    path.write_bytes(_clip(64, 48, 3, seed=1))
    return path


def _settings(**kw):
    return trainer.TrainerSettings(**dict(dict(steps=3, batch=2, crop=32, log_every=2,
                                               features=8, depth=2), **kw))


def test_train_marks_crops_and_steps_on_the_profiler(media):
    """Three steps of two crops from a three-frame clip: six crops, read
    over two passes of the file (the read that finds its end between
    them), and the loss read at steps 1 and 2 and once at the end."""
    with _cpu_profile() as prof:
        trainer.train([str(media)], _settings(), device="cpu")
    assert _ranges(prof, "host.") == {
        "host.trainer.read": 7, "host.trainer.to_rgb": 6,
        "host.trainer.downsample": 3, "host.trainer.h2d": 3,
        "host.trainer.launch": 3, "host.trainer.loss_read": 3}


def test_to_rgb_bills_the_crops_window_not_the_frame(media):
    """Each ``to_rgb`` note bills the planes of the crop's window, widened
    to the 4:2:0 chroma grid, which are fewer bytes than the frame's."""
    height, width, crop, seed = 48, 64, 31, 9
    notes = []
    stream = trainer.hr_crop_stream([str(media)], crop, np.random.default_rng(seed))
    with trainer.hop_sink.bound(lambda hop, nbytes, _s: notes.append((hop, nbytes))):
        for _ in range(5):
            next(stream)
    draws = np.random.default_rng(seed)
    want = []
    for _ in range(5):
        top = int(draws.integers(0, height - crop + 1))
        left = int(draws.integers(0, width - crop + 1))
        rows = -(-(top + crop) // 2) * 2 - (top - top % 2)
        cols = -(-(left + crop) // 2) * 2 - (left - left % 2)
        want.append(rows * cols + 2 * (rows // 2) * (cols // 2))
    got = [nbytes for hop, nbytes in notes if hop == "to_rgb"]
    assert got == want
    assert max(got) < height * width + 2 * (height // 2) * (width // 2)


def test_train_summary_holds_host_seconds_per_hop(media):
    summary = trainer.train([str(media)], _settings(), device="cpu")
    assert set(summary["host_s"]) == TRAINER_HOPS
    assert all(s >= 0 for s in summary["host_s"].values())
    assert summary["host_s"]["to_rgb"] > 0
    assert not trainer.hop_sink.is_bound()


def test_cli_train_prints_host_seconds(media, capsys):
    rc = cli_main(["train", "--data", str(media), "--steps", "2", "--batch", "2",
                   "--crop", "32", "--features", "8", "--depth", "2",
                   "--device", "cpu"])
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("trained to step 2 (loss") and "devices 1; host s: " in last
    assert all(f"{hop} " in last for hop in TRAINER_HOPS)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: launch, device and the download stream "
                    "exist on CUDA only")


@pytest.mark.cuda
def test_launch_and_device_billed_once_per_dispatch_on_the_card(card):
    """On the card every engine hop is billed once per dispatch, and
    ``device`` agrees within 2% with CUDA events around ``_core``."""
    engine = FrameUpscaler()
    core, timed = engine._core, []

    def timed_core(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = core(*args)
        end.record()
        timed.append((start, end))
        return out

    clip = _clip(1280, 720, 24)
    engine.upscale_to(io.BytesIO(clip), io.BytesIO())  # warm-up
    engine._core = timed_core
    got = []
    with engine.hop_sink.bound(lambda hop, n, s: got.append((hop, s))):
        assert engine.upscale_to(io.BytesIO(clip), io.BytesIO()) == 24
    counts = Counter(hop for hop, _ in got)
    assert counts == {"read": 4, "h2d": 3, "launch": 3, "compute": 3, "d2h": 3,
                      "write": 3, "device": 3}
    device = sum(s for hop, s in got if hop == "device")
    events = sum(a.elapsed_time(b) for a, b in timed) / 1e3
    assert device > 0
    assert abs(device - events) <= 0.02 * events, (device, events)


def _serial_bytes(engine, clip: bytes) -> bytes:
    """The engine's stream as a serial path makes it: each batch padded
    and cut into shards as ``_dispatch`` does, each shard's ``_core`` on
    its card and copied back on the current stream before the next one
    starts, then written by ``Y4MWriter``."""
    reader = Y4MReader(io.BytesIO(clip))
    hdr = reader.header
    out = io.BytesIO()
    writer = Y4MWriter(out, hdr.scaled(engine.config.scale))
    eff = engine.batch_for(hdr.height, hdr.width)
    for planes in pipeline._batched(iter(reader), eff):
        n = planes[0].shape[0]
        total = max(n, eff) if engine.n_devices > 1 else n
        rows = total // engine.n_devices
        padded = [np.concatenate([a, np.zeros((total - n, *a.shape[1:]), np.uint8)])
                  for a in planes]
        shards = []
        for i, device in enumerate(engine.devices):
            with torch.cuda.device(device):
                dev = [torch.from_numpy(a[i * rows:(i + 1) * rows]).to(device)
                       for a in padded]
                shards.append([t.cpu() for t in engine._core(*dev, *hdr.subsampling)])
        y2, cb2, cr2 = (torch.cat(parts).numpy()[:n] for parts in zip(*shards))
        for i in range(n):
            writer.write_frame(y2[i], cb2[i], cr2[i])
    return out.getvalue()


@pytest.mark.cuda
@pytest.mark.parametrize("scale, width, height", [(4, 960, 540), (2, 1920, 1080)])
@pytest.mark.parametrize("listed", [1, 2])
def test_card_stream_is_byte_identical_to_the_serial_path(card, scale, width, height,
                                                          listed):
    """17 frames (two batches of 8 and a short one) through ``upscale_to``
    on one card and on ``cuda:0`` listed ``listed`` times: the same bytes
    as each shard computed and copied back in turn."""
    engine = FrameUpscaler(UpscalerConfig(scale=scale), devices=["cuda:0"] * listed)
    assert len(engine._download) == 1
    clip = _clip(width, height, 17, seed=scale)
    out = io.BytesIO()
    assert engine.upscale_to(io.BytesIO(clip), out) == 17
    assert out.getvalue() == _serial_bytes(engine, clip)


@pytest.mark.cuda
def test_d2h_runs_on_a_stream_of_its_own_beside_compute(card, tmp_path):
    """In a profile of a 540p stream at x4, every device-to-host copy runs
    on another stream than every kernel, and some copy overlaps a
    kernel."""
    engine = FrameUpscaler(UpscalerConfig(scale=4))
    download = engine._download[engine.device]
    assert download != torch.cuda.current_stream(engine.device)
    clip = _clip(960, 540, 32)
    engine.upscale_to(io.BytesIO(clip), io.BytesIO())  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.upscale_to(io.BytesIO(clip), io.BytesIO())
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and "stream" in e.get("args", {})]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert copies and kernels
    assert not ({e["args"]["stream"] for e in copies}
                & {e["args"]["stream"] for e in kernels})
    assert any(k["ts"] < c["ts"] + c["dur"] and c["ts"] < k["ts"] + k["dur"]
               for c in copies for k in kernels)
