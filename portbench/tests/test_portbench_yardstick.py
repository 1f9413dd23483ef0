"""The benchmark's frozen arithmetic against counts by hand."""

import json

import pytest

from portbench import harness, yardstick


def _config(name):
    return json.loads((harness.BENCH_DIR / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("config, height, width, tflop", [
    ("upscaler-x2", 1080, 1920, 1.9317),   # (19200 + 884736 + 27648) x 2,073,600
    ("upscaler-x4", 540, 960, 0.5259),     # (19200 + 884736 + 110592) x 518,400
])
def test_flops_per_frame_by_hand(config, height, width, tflop):
    flops = yardstick.upscaler_flops_per_frame(_config(config), height, width)
    assert flops / 1e12 == pytest.approx(tflop, abs=5e-5)


def test_tail_bytes_by_hand():
    # (8, 540, 960, 48) bf16 read; (8, 2160, 3840) + 2 x (8, 1080, 1920) u8 written
    assert yardstick.s2d_tail_bytes(8, 1080, 1920, 2) == (
        8 * 540 * 960 * 48 * 2 + 8 * 2160 * 3840 + 2 * 8 * 1080 * 1920)
    seconds = yardstick.least_seconds(yardstick.s2d_tail_bytes(8, 1080, 1920, 2), 0,
                                      yardstick.card_rates("NVIDIA H100 80GB HBM3"))
    assert seconds * 1e3 == pytest.approx(0.1486, abs=1e-4)


def test_quantize_bytes_and_rates():
    assert yardstick.quantize_bytes(10) == 50
    assert yardstick.card_rates("NVIDIA H100 PCIe")[2] == 756e12
    assert yardstick.card_rates("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12, 989e12)
    with pytest.raises(RuntimeError):
        yardstick.card_rates("cpu")


def test_least_seconds_takes_the_larger_bound():
    rates = (1.0, 2.0, 4.0)
    assert yardstick.least_seconds(10, 4, rates) == 10
    assert yardstick.least_seconds(1, 40, rates) == 20
    assert yardstick.least_seconds(1, 40, rates, tensor=True) == 10


def test_train_step_device_ms_reads_the_timeline_between_steps():
    from portbench.devtrace import Timeline

    reader = harness.load_module(harness.BENCH_DIR / "metrics" / "train_step_device_ms.py")
    # three steps start at 0, 1 and 2 s; each runs 2 ms of kernels, partly
    # overlapping, and its crops' copy runs 1 ms, which is the data path's
    ops = [("conv", 0, 0.0100, 0.0115), ("add", 0, 0.0110, 0.0120),
           ("Memcpy HtoD (Pinned -> Device)", 0, 0.9, 0.901),
           ("conv", 0, 1.0100, 1.0120), ("Memcpy HtoD (Pinned -> Device)", 0, 1.9, 1.901),
           ("conv", 0, 2.0100, 2.0120)]
    spans = [("host.step", t, t + 0.05) for t in (0.0, 1.0, 2.0)]
    spans.append(("host.crop_stream", 0.1, 0.9))
    readings = {"traffic": {"driver": "train"},
                "timeline": Timeline(3.0, ops, spans, [0])}
    assert reader.read(readings) == pytest.approx(2.0)
    readings["timeline"] = Timeline(3.0, [], spans, [0])
    assert reader.read(readings) is None
    readings["traffic"] = {"driver": "stream"}
    assert reader.read(readings) is None
