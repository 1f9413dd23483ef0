"""The per-layer metrics that read the program's own hops: the engine's
``HopSink`` notes (``readings["hops"]``) and the trainer's
``host.trainer.*`` ranges on the profiler's timeline.  Each is found by
name, reads a number where its hops exist and nothing where they do not
(a CPU rehearsal has no ``launch``; a program without these hops has
none), and the harness's readings are what they were."""

import json

import pytest

from portbench import harness
from portbench.devtrace import Timeline
from portbench.tests import tiny

SERVING = ("engine_host_share", "engine_launch_ms_per_batch",
           "engine_stream_io_ms_per_batch", "engine_device_ms_per_batch")
TRAINING = ("train_data_host_ms_per_step", "train_to_rgb_ms_per_step",
            "train_launch_ms_per_step")
SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def test_the_seven_readers_are_found_by_name():
    readers = harness.readers()
    spec = {m["name"]: m for m in SPEC["per_layer"]}
    for name in SERVING + TRAINING:
        assert readers[name].UNIT == spec[name]["unit"]
        assert spec[name]["source"] == "program_span"
        assert spec[name]["better"] == "lower"
    assert [m["name"] for m in SPEC["per_layer"][-7:]] == list(SERVING + TRAINING)


def _serving(hops, window_s=2.0):
    return {"hops": hops, "window_s": window_s, "timeline": None}


# two batches on the card: 10 ms read, 1 ms h2d, 3 ms launch, 20 ms of
# waiting, 2 ms d2h, 15 ms write, and the card's 30 ms, each a batch
CARD_HOPS = [(hop, s) for _ in range(2) for hop, s in (
    ("read", 0.010), ("h2d", 0.001), ("launch", 0.003), ("compute", 0.020),
    ("d2h", 0.002), ("write", 0.015), ("device", 0.030))]


@pytest.mark.parametrize("name, want", [
    ("engine_host_share", 100.0 * 2 * (0.010 + 0.001 + 0.003 + 0.015) / 2.0),
    ("engine_launch_ms_per_batch", 3.0),
    ("engine_stream_io_ms_per_batch", 25.0),
    ("engine_device_ms_per_batch", 30.0),
])
def test_serving_readers_read_the_engines_hops(name, want):
    reader = harness.readers()[name]
    assert reader.read(_serving(CARD_HOPS)) == pytest.approx(want)
    # the hops a program without them bills (h2d, compute, d2h) read nothing
    older = [(hop, s) for hop, s in CARD_HOPS if hop in ("h2d", "compute", "d2h")]
    assert reader.read(_serving(older)) is None
    assert reader.read({"window_s": 2.0, "timeline": None}) is None


def _training(spans, steps=4):
    return {"steps": steps, "window_s": 1.0, "timeline": Timeline(1.0, [], spans, [0])}


@pytest.mark.parametrize("name, want", [
    ("train_data_host_ms_per_step", 1e3 * (0.1 + 0.4 + 0.02 + 0.01) / 4),
    ("train_to_rgb_ms_per_step", 1e3 * 0.4 / 4),
    ("train_launch_ms_per_step", 1e3 * 0.05 / 4),
])
def test_training_readers_read_the_trainers_ranges(name, want):
    harness_spans = [("host.crop_stream", 0.0, 0.55), ("host.step", 0.6, 0.64)]
    program_spans = [("host.trainer.read", 0.0, 0.1), ("host.trainer.to_rgb", 0.1, 0.5),
                     ("host.trainer.downsample", 0.5, 0.52),
                     ("host.trainer.h2d", 0.52, 0.53), ("host.trainer.launch", 0.59, 0.64)]
    reader = harness.readers()[name]
    assert reader.read(_training(harness_spans + program_spans)) == pytest.approx(want)
    assert reader.read(_training(harness_spans)) is None
    assert reader.read(_training(program_spans, steps=0)) is None
    assert reader.read(_serving(CARD_HOPS)) is None


def _probe(bench):
    """A reader added to the copy that writes down what it is handed."""
    (bench / "metrics" / "probe_readings.py").write_text(
        "import json\nfrom pathlib import Path\n\nUNIT = 'n'\n\n\n"
        "def read(r):\n"
        "    hops = sorted({h for h, _ in r.get('hops', ())})\n"
        "    spans = sorted({n for n, _, _ in r['timeline'].spans})\n"
        "    Path(__file__).with_name('probe.json').write_text(\n"
        "        json.dumps({'keys': sorted(r), 'hops': hops, 'spans': spans}))\n"
        "    return 1.0\n")


def _probed(bench):
    return json.loads((bench / "metrics" / "probe.json").read_text())


def test_serving_rehearsal_bills_the_new_hops_into_the_harness_readings(tmp_path):
    bench = tiny.bench_copy(tmp_path)
    tiny.add_cell(bench, "tiny-x2", "x2-1080p-stream", tiny.SERVE_CONFIG, tiny.SERVE_TRAFFIC)
    _probe(bench)
    rc, line, err = tiny.run(bench, "tiny-x2", trace=1)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    probed = _probed(bench)
    assert probed["keys"] == sorted([
        "batch", "card", "chips", "compare_detail", "config", "core_ms", "frames",
        "hops", "timeline", "traffic", "window_s"])
    # on the CPU the engine bills its host hops, but no launch and no device
    assert probed["hops"] == ["compute", "d2h", "h2d", "read", "write"]
    assert "host.engine.read" in probed["spans"] and "host.engine.write" in probed["spans"]
    assert not set(SERVING) & set(line["metrics"])
    assert {"engine_h2d_ms_per_batch", "engine_compute_wait_share"} <= set(line["metrics"])


def test_training_rehearsal_reads_the_trainers_ranges(tmp_path):
    bench = tiny.bench_copy(tmp_path)
    tiny.add_cell(bench, "tiny-train", "x2-train-720p", tiny.SERVE_CONFIG, tiny.TRAIN_TRAFFIC)
    _probe(bench)
    rc, line, err = tiny.run(bench, "tiny-train", trace=1)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    probed = _probed(bench)
    assert probed["keys"] == sorted([
        "card", "chips", "compare_detail", "config", "data_ms", "steps", "timeline",
        "traffic", "window_s"])
    assert {f"host.trainer.{hop}" for hop in ("read", "to_rgb", "downsample", "h2d",
                                              "launch")} <= set(probed["spans"])
    for name in TRAINING:
        assert line["metrics"][name]["value"] > 0, name
    assert not set(SERVING) & set(line["metrics"])
    assert "train_data_ms_per_step" in line["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("like, traffic, names", [
    ("x2-1080p-stream", tiny.SERVE_TRAFFIC, SERVING),
    ("x2-train-720p", tiny.TRAIN_TRAFFIC, TRAINING),
])
def test_the_readers_read_the_program_on_the_card(cuda_card, tmp_path, like, traffic,
                                                  names):
    bench = tiny.bench_copy(tmp_path)
    tiny.add_cell(bench, "tiny-card", like, tiny.SERVE_CONFIG, traffic)
    rc, line, err = tiny.run(bench, "tiny-card", trace=1, rehearsal=False)
    assert rc == 0, err
    for name in names:
        assert line["metrics"][name]["value"] > 0, name
