"""The harness on the card at a tiny size: the profiler's device
timeline, the kernels' names and the device's line (``-m cuda``)."""

import pytest

from portbench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("like, traffic", [
    ("x2-1080p-stream", tiny.SERVE_TRAFFIC),
    ("x4-540p-stream", tiny.SERVE_TRAFFIC),
    ("x2-train-720p", tiny.TRAIN_TRAFFIC),
])
def test_traced_tiny_cell_on_the_card(cuda_card, tmp_path, like, traffic):
    bench = tiny.bench_copy(tmp_path)
    tiny.add_cell(bench, "tiny-card", like, tiny.SERVE_CONFIG, traffic)
    rc, line, err = tiny.run(bench, "tiny-card", trace=1, rehearsal=False)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert line["breakdown"]["device_ops"]
    idle = [v for k, v in line["metrics"].items() if k.startswith("device_idle_share")]
    assert len(idle) == 1 and 0 <= idle[0]["value"] <= 100
