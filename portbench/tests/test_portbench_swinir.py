"""The SwinIR cell's pieces on the CPU: a tiny ``stream_arch`` cell
through the harness's rehearsal, the three readers it adds, and the
frozen operation count against PyTorch's own count of the reference."""

import hashlib
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, seeded
from portbench.reference import swinir as reference
from portbench.swinir_flops import swinir_flops_per_frame
from portbench.tests import tiny
from portbench.traffic import stream_arch
from portbench.traffic.stream import compare

TINY_SWINIR = {"embed_dim": 12, "depths": [2, 2], "num_heads": [2, 2], "window_size": 4,
               "num_feat": 8, "batch": 2}
TINY_TRAFFIC = {"width": 28, "height": 20, "pool": 4, "warm_batches": 2}
READERS = ("mfu.swinir", "window_attention_ms_per_batch", "window_attention_share")


def _config(**changes):
    path = harness.BENCH_DIR / "configs" / "swinir-m-x4-real.json"
    return dict(json.loads(path.read_text()), **changes)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_tiny_stream_arch_cell_is_correct_in_rehearsal(tmp_path):
    bench = tiny.bench_copy(tmp_path)
    before = _digests(bench)
    tiny.add_cell(bench, "tiny-swinir", "swinir-x4-540p-stream", TINY_SWINIR, TINY_TRAFFIC)
    rc, line, err = tiny.run(bench, "tiny-swinir")
    assert rc == 0, err
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"frames_per_s", "frame_latency_p95_ms", "setup_s"}
    rc, line, err = tiny.run(bench, "tiny-swinir", trace=1)
    assert rc == 0, err
    # on the CPU the engine times no span: the SwinIR readers read nothing
    assert not set(READERS) & set(line["metrics"])
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_rate_spans_whole_batches():
    """The window's rate counts the frames of whole batches, up to the
    arrival of the last one's last frame."""

    class Ctx:
        seed, seconds = 7, 10.0
        tracer = type("T", (), {"open": lambda self: None, "close": lambda self: None})()
        window_open = None

        def mark(self, phase):
            pass

    class Source:
        read_at = [0.0] * 64
        close_at = None

    sink = stream_arch.BatchSink(Ctx(), b"", (1, 1, 1), 4, Source(), 4, 1)
    for i in range(14):
        sink._frame_done(1.0 + i)  # the 4th frame (index 3) opens the window
    assert sink.batch_ends == [(4, 8.0), (8, 12.0)]


def _readings(driver="stream_arch", arch="swinir", card="NVIDIA H100 80GB HBM3"):
    hops = [(hop, s) for _ in range(2) for hop, s in (
        ("launch", 0.003), ("device", 1.0), ("attention", 0.25), ("compute", 0.9))]
    return {"traffic": {"driver": driver, "width": 960, "height": 540},
            "config": _config(arch=arch), "card": card, "chips": 1, "frames": 80,
            "window_s": 10.0, "hops": hops, "timeline": None}


@pytest.mark.parametrize("name, want", [
    ("mfu.swinir", 100.0 * swinir_flops_per_frame(_config(), 540, 960) * 8 / 989e12),
    ("window_attention_ms_per_batch", 250.0),
    ("window_attention_share", 25.0),
])
def test_readers_read_swinir_cells_only(name, want):
    reader = harness.readers()[name]
    assert reader.read(_readings()) == pytest.approx(want)
    assert reader.read(_readings(driver="stream")) is None
    assert reader.read(_readings(arch="other")) is None
    no_spans = dict(_readings(), hops=[("launch", 0.003), ("device", 1.0)])
    if name != "mfu.swinir":
        assert reader.read(no_spans) is None
    else:
        assert reader.read(_readings(card=None)) is None


@pytest.mark.parametrize("height, width", [(20, 28), (16, 16)])
def test_frozen_count_equals_pytorchs_count_of_the_reference(height, width):
    config = _config(**TINY_SWINIR, head_gain=1.0)
    weights = stream_arch.swinir_weights(config, 3, "cpu")
    rgb = torch.rand((1, 3, height, width), generator=torch.Generator().manual_seed(2))
    with FlopCounterMode(display=False) as counter:
        reference.forward(weights, rgb, config)
    assert counter.get_total_flops() == swinir_flops_per_frame(config, height, width)


def test_seeded_weights_are_the_models_and_repeat_with_the_seed():
    from downloader_tpu_torch.compute.models import build_model

    config = _config(**TINY_SWINIR)
    weights = stream_arch.swinir_weights(config, 2**31 + 3, "cpu")
    model = build_model(stream_arch.swinir_config(config))
    assert {k: tuple(v.shape) for k, v in weights.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    again = stream_arch.swinir_weights(config, 2**31 + 3, "cpu")
    assert all(torch.equal(weights[k], again[k]) for k in weights)
    table = weights["layers.0.residual_group.blocks.0.attn.relative_position_bias_table"]
    assert 0.01 < table.std().item() < 0.03


def test_control_fails_the_swinir_cells_limits():
    """The plain reference in float8 e4m3, put in the program's place, at
    the cell's widths and a frame size a CPU test holds, fails the limits
    calibrated at the cell's own size on the card."""
    cell = json.loads((harness.BENCH_DIR / "workloads" / "swinir-x4-540p-stream.json")
                      .read_text())
    limits = {k: v["limit"] for k, v in cell["checks"].items()}
    config = _config()
    seed = 2**31 + 9
    weights = stream_arch.swinir_weights(config, seed, "cpu")
    planes = seeded.frames(1, 48, 64, 2, seed + 1, "cpu")
    want = [p[0].numpy() for p in reference.upscale(weights, *planes, config)]
    got = [p[0].numpy() for p in reference.upscale(weights, *planes, config, "fp8")]
    gaps = compare(got, want)
    assert any(gaps[k] > limits[k] for k in gaps), gaps
