"""The port's engine and ``infer`` over several devices, on the CPU —
mirrors ``tests/test_upscale.py:162-196`` (the engine adopts the mesh;
sharded inference is byte-identical to one device) and ``:493-523``
(the overlap probe), and covers ``make_infer_fn(mesh=)``.

The reference's mesh is XLA's 8 virtual host devices
(``tests/conftest.py``); the port's counterpart is an engine over
``["cpu"] * 8``: one replica, eight shards a dispatch.
"""

import math

import numpy as np
import pytest
import torch

from downloader_tpu.compute.models.upscaler import UpscalerConfig as JaxConfig
from downloader_tpu.compute.pipeline import FrameUpscaler as JaxUpscaler
from downloader_tpu_torch.compute.infer import make_infer_fn
from downloader_tpu_torch.compute.models.upscaler import Upscaler, UpscalerConfig
from downloader_tpu_torch.compute.overlap_probe import measure_overlap
from downloader_tpu_torch.compute.parallel import MeshPlan, decision_cache
from downloader_tpu_torch.compute.parallel.chooser import clear_decisions
from downloader_tpu_torch.compute.pipeline import FrameUpscaler, device_peak_tflops
from downloader_tpu_torch.compute.weights import from_flax

CONFIG = UpscalerConfig(features=8, depth=2)


def _planes(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, h, w), dtype=np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8),
            rng.integers(0, 256, (n, h // 2, w // 2), dtype=np.uint8))


def test_frame_upscaler_shards_over_devices():
    """The engine adopts the devices it is given and rounds the batch up
    to a multiple of them; on the CPU ``use_mesh`` has one device."""
    engine = FrameUpscaler(CONFIG, batch=4, devices=["cpu"] * 8)
    assert engine.n_devices == 8 and engine.batch == 8
    assert engine.batch % engine.n_devices == 0
    assert len(engine._replicas) == 1  # one replica per distinct device
    assert FrameUpscaler(CONFIG, batch=5, devices=["cpu"] * 2).batch == 6
    assert FrameUpscaler(CONFIG, device="cpu").n_devices == 1
    with pytest.raises(ValueError, match="no device"):
        FrameUpscaler(CONFIG, devices=[])


@pytest.fixture(scope="module")
def jax_sharded():
    """The reference's 8-device engine (seed 3) and its params bridged."""
    engine = JaxUpscaler(config=JaxConfig(features=8, depth=2), batch=8,
                         use_mesh=True, seed=3)
    assert engine.n_devices == 8
    tree = {"params": {m: {k: np.asarray(v) for k, v in leaves.items()}
                       for m, leaves in engine.params["params"].items()}}
    return engine, from_flax(tree, CONFIG)


def test_sharded_inference_matches_single_device(jax_sharded):
    """Sharding is a pure layout decision: the 8-device engine's u8
    output is byte-identical to the one-device engine's (n = 5 < batch:
    the zero-pad path), and within the reference's own bound (<= 1 u8
    step, > 97% exact; tests/test_upscale.py) of the JAX 8-device engine
    on the same weights."""
    ref, params = jax_sharded
    sharded = FrameUpscaler(CONFIG, batch=8, params=params, devices=["cpu"] * 8)
    single = FrameUpscaler(CONFIG, batch=8, params=params, device="cpu",
                           use_mesh=False)
    assert sharded.n_devices == 8 and single.n_devices == 1
    y, cb, cr = _planes(5, 24, 32, seed=0)
    out_sharded = sharded.upscale_batch(y, cb, cr, 2, 2)
    out_single = single.upscale_batch(y, cb, cr, 2, 2)
    out_ref = ref.upscale_batch(y, cb, cr, 2, 2)
    for got, one, want in zip(out_sharded, out_single, out_ref):
        assert got.dtype == np.uint8 and got.shape[0] == 5
        np.testing.assert_array_equal(got, one)
        diff = np.abs(got.astype(int) - np.asarray(want).astype(int))
        assert diff.max() <= 1, diff.max()
        assert (diff == 0).mean() > 0.97, (diff == 0).mean()


def test_sharded_engine_bills_three_hops_once_per_batch():
    """h2d, compute and d2h are billed over all shards: one bill per hop
    and batch, the bytes of the padded batch."""
    engine = FrameUpscaler(CONFIG, batch=4, devices=["cpu"] * 4)
    billed = {}

    def note(hop, nbytes, seconds):
        billed.setdefault(hop, []).append(nbytes)

    y, cb, cr = _planes(3, 8, 8, seed=1)
    with engine.hop_sink.bound(note):
        engine.upscale_batch(y, cb, cr, 2, 2)
    assert sorted(billed) == ["compute", "d2h", "h2d"]
    assert all(len(v) == 1 for v in billed.values()), billed
    assert billed["h2d"] == [4 * (64 + 16 + 16)]  # padded to the batch of 4
    assert billed["d2h"] == [4 * (256 + 64 + 64)]


def test_sharded_stream_matches_single_device(tmp_path):
    """``upscale_to`` through the 3-deep queue on 4 shards: the same
    stream as one device, a short last batch included."""
    from downloader_tpu_torch.compute.video import Y4MHeader, Y4MWriter

    src = tmp_path / "src.y4m"
    y, cb, cr = _planes(7, 16, 24, seed=2)
    with open(src, "wb") as fh:
        writer = Y4MWriter(fh, Y4MHeader(width=24, height=16))
        for i in range(7):
            writer.write_frame(y[i], cb[i], cr[i])
    outs = []
    for kwargs in ({"device": "cpu"}, {"devices": ["cpu"] * 4}):
        dst = tmp_path / f"dst{len(outs)}.y4m"
        engine = FrameUpscaler(CONFIG, batch=4, seed=5, **kwargs)
        assert engine.upscale_y4m(str(src), str(dst)) == 7
        outs.append(dst.read_bytes())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("n,data", [(5, 4), (8, 4), (3, 1)])
def test_infer_on_a_mesh_is_byte_identical_to_one_device(n, data):
    """``make_infer_fn(mesh=)`` splits the batch over the plan's data
    devices (zero-padded to a multiple of them) through the shard_map
    route; the rows come back byte-identical to the one-device path."""
    clear_decisions()
    params = Upscaler(CONFIG, seed=4).state_dict()
    frames = np.random.default_rng(6).integers(0, 256, (n, 6, 10, 3), np.uint8)
    want = make_infer_fn(CONFIG, "cpu")(params, frames)
    plan = MeshPlan.over(["cpu"] * data)
    got = make_infer_fn(CONFIG, mesh=plan)(params, frames)
    assert got.shape == (n, 12, 20, 3) and got.dtype == torch.uint8
    assert torch.equal(got, want)
    strategy = "shard_map" if data > 1 else "jit"
    assert [d.strategy for d in decision_cache().values()] == [strategy]
    clear_decisions()


def test_overlap_probe_runs_on_the_port_engine():
    """The reference's drill on the port's CPU engine, three runs.  The
    CPU engine computes at dispatch, so nothing overlaps here: the
    alarm (overlap >= 0.5, pipelined <= 0.85 x serial) is the card's
    (``test_overlap_probe_alarm_on_the_card``, ``chip_smoke.py`` phase
    15).  Here the drill must run and its walls must bound each other."""
    engine = FrameUpscaler(UpscalerConfig(features=16, depth=2), batch=4,
                           device="cpu")
    results = [measure_overlap(engine, batches=4, frame_interval=0.005)
               for _ in range(3)]
    for result in results:
        assert set(result) == {"io_s", "compute_s", "serial_s", "pipelined_s",
                               "overlap"}
        assert all(math.isfinite(v) for v in result.values())
        assert result["io_s"] == pytest.approx(4 * 4 * 0.005)
        assert result["serial_s"] >= result["io_s"]
        assert result["pipelined_s"] >= result["io_s"]


@pytest.mark.cuda
def test_overlap_probe_alarm_on_the_card():
    """The reference's alarm (``tests/test_upscale.py:493-523``) on the
    card's engine at 720p, best of 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    engine = FrameUpscaler()
    last = None
    for _ in range(3):
        last = measure_overlap(engine, height=720, width=1280)
        if last["overlap"] >= 0.5 and last["pipelined_s"] <= last["serial_s"] * 0.85:
            break
    assert last["overlap"] >= 0.5, last
    assert last["pipelined_s"] <= last["serial_s"] * 0.85, last


def test_device_peak_tflops_holds_gpu_peaks_only():
    assert device_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert device_peak_tflops("NVIDIA H100 PCIe") == 756.0
    assert device_peak_tflops("NVIDIA H200") == 989.0
    for name in ("cpu", "TPU v5e", "TPU v5 lite"):
        assert device_peak_tflops(name) is None
