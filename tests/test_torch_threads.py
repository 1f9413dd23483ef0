"""The port's engine under the service's conditions, on the CPU: hops
billed on every device, and calls from concurrent jobs' threads that
keep the process's TF32 flags and each caller's weights apart; plus the
trainer's model axis on one device, as the reference reads it."""

import os
import threading

import numpy as np
import torch

from downloader_tpu_torch.cli import main as cli_main
from downloader_tpu_torch.compute.infer import make_infer_fn
from downloader_tpu_torch.compute.models.upscaler import Upscaler, UpscalerConfig
from downloader_tpu_torch.compute.pipeline import FrameUpscaler
from downloader_tpu_torch.compute.video import Y4MHeader, Y4MWriter

TINY = UpscalerConfig(features=8, depth=2)


def _planes(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, h, w), np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), np.uint8))


def _run_threads(n, target):
    errors = []

    def run(i):
        try:
            target(i)
        except BaseException as err:  # surfaced by the assert below
            errors.append(err)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []


def test_engine_bills_three_hops_on_the_cpu():
    """The counterpart of the reference's
    ``test_engine_bills_three_hops_and_caches_decisions``: ``h2d``,
    ``compute`` and ``d2h`` reach a bound sink on the CPU too, with the
    CUDA path's byte counts (planes in; u8 planes out, twice)."""
    engine = FrameUpscaler(TINY, batch=8, device="cpu")
    y, cb, cr = _planes(8, 16, 16, seed=0)
    billed = {}

    def note(hop, nbytes, seconds):
        total = billed.setdefault(hop, [0, 0.0, 0])
        total[0] += nbytes
        total[1] += seconds
        total[2] += 1

    with engine.hop_sink.bound(note):
        y2, cb2, cr2 = engine.upscale_batch(y, cb, cr, 2, 2)
    out_bytes = y2.nbytes + cb2.nbytes + cr2.nbytes
    assert set(billed) == {"h2d", "compute", "d2h"}
    assert billed["h2d"][0] == y.nbytes + cb.nbytes + cr.nbytes
    assert billed["compute"][0] == billed["d2h"][0] == out_bytes
    assert all(count == 1 and seconds >= 0
               for _, seconds, count in billed.values())

    # chunked through the transfer queue: one bill per hop and batch
    billed.clear()
    engine.batch = 4
    with engine.hop_sink.bound(note):
        engine.upscale_batch(y, cb, cr, 2, 2)
    assert {hop: v[2] for hop, v in billed.items()} == {
        "h2d": 2, "compute": 2, "d2h": 2}
    assert billed["compute"][0] == out_bytes


def test_concurrent_f32_calls_keep_tf32_off_and_restore_the_flags():
    """4 threads x 20 calls of an f32 engine: TF32 is off inside every
    call, and the process flags come back exactly as they were."""
    engine = FrameUpscaler(UpscalerConfig(features=8, depth=2,
                                          compute_dtype=torch.float32),
                           batch=2, device="cpu")
    seen = []
    hook = engine.model.stem.register_forward_hook(
        lambda *_: seen.append((torch.backends.cudnn.allow_tf32,
                                torch.backends.cuda.matmul.allow_tf32)))
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        planes = _planes(2, 12, 16, seed=3)

        def calls(_i):
            for _ in range(20):
                engine.upscale_batch(*planes, 2, 2)

        _run_threads(4, calls)
        assert len(seen) == 80
        assert set(seen) == {(False, False)}
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        hook.remove()
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_infer_keeps_each_callers_params_across_threads():
    """Two threads, two param sets, 20 calls each on the one cached
    module: every output is the single-threaded output of its own
    params."""
    infer = make_infer_fn(TINY, device="cpu")
    params = [Upscaler(TINY, seed=s).state_dict() for s in (1, 2)]
    frames = np.random.default_rng(4).integers(0, 256, (2, 12, 16, 3), np.uint8)
    want = [infer(p, frames).clone() for p in params]
    assert not torch.equal(want[0], want[1])
    got = [[], []]

    def calls(i):
        for _ in range(20):
            got[i].append(infer(params[i], frames))

    _run_threads(2, calls)
    for i in range(2):
        assert len(got[i]) == 20
        for out in got[i]:
            assert torch.equal(out, want[i])


def test_train_command_takes_a_model_axis_on_one_device(tmp_path, capsys):
    """``train --model-axis 2`` on one device trains, as the reference's
    does: the axis splits a mesh only where there is more than one."""
    media = tmp_path / "media"
    media.mkdir()
    rng = np.random.default_rng(0)
    with open(media / "clip.y4m", "wb") as fh:
        writer = Y4MWriter(fh, Y4MHeader(width=32, height=24,
                                         colorspace="420jpeg"))
        for _ in range(2):
            writer.write_frame(rng.integers(0, 256, (24, 32), np.uint8),
                               rng.integers(0, 256, (12, 16), np.uint8),
                               rng.integers(0, 256, (12, 16), np.uint8))
    ckpt = tmp_path / "ckpt"
    assert cli_main(["train", "--data", str(media), "--steps", "2",
                     "--batch", "2", "--crop", "16", "--features", "8",
                     "--depth", "2", "--model-axis", "2",
                     "--checkpoint-dir", str(ckpt), "--device", "cpu"]) == 0
    assert "trained to step 2" in capsys.readouterr().out
    assert os.listdir(ckpt) == ["2"]
