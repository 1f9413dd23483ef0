"""Cells, configurations, traffic and per-layer metrics are found by
name: added as new files to a copy of the benchmark, they run, and no
file that was there changes."""

import hashlib

from portbench.tests import tiny

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_cell_config_and_metric_are_new_files_only(tmp_path):
    bench = tiny.bench_copy(tmp_path)
    before = _digests(bench)
    tiny.add_cell(bench, "tiny-added", "x2-1080p-stream", tiny.SERVE_CONFIG,
                  dict(tiny.SERVE_TRAFFIC, width=48, height=32))
    (bench / "metrics" / "added_frames_in_window.py").write_text(
        'UNIT = "frames"\n\n\ndef read(r):\n    return r.get("frames")\n')
    rc, line, err = tiny.run(bench, "tiny-added", trace=1)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    assert line["metrics"]["added_frames_in_window"]["value"] > 0
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(str(p) for p in set(after) - set(before)) == [
        "configs/tiny-added.json", "metrics/added_frames_in_window.py",
        "traffic/tiny-added.json", "workloads/tiny-added.json"]


def test_last_line_keys_and_checks_last(tmp_path):
    bench = tiny.bench_copy(tmp_path)
    tiny.add_cell(bench, "tiny-x2", "x2-1080p-stream", tiny.SERVE_CONFIG, tiny.SERVE_TRAFFIC)
    rc, line, err = tiny.run(bench, "tiny-x2")
    assert rc == 0, err
    assert [k for k in line if k in LINE_KEYS] == LINE_KEYS
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"frames_per_s", "frame_latency_p95_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    for name, check in line["checks"].items():
        assert f"check {name}: {check['value']} against limit {check['limit']}" in err
    # the checks are the last lines of standard error
    assert err.strip().splitlines()[-1].startswith("check ")


def test_traced_line_has_device_window_and_breakdown(tmp_path):
    bench = tiny.bench_copy(tmp_path)
    tiny.add_cell(bench, "tiny-train", "x2-train-720p", tiny.SERVE_CONFIG, tiny.TRAIN_TRAFFIC)
    rc, line, err = tiny.run(bench, "tiny-train", trace=1)
    assert rc == 0, err
    assert line["correct"], line["checks"]
    assert "train_data_ms_per_step" in line["metrics"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())


