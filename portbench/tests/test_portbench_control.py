"""The control (the plain reference in float8 e4m3, put in the
program's place) fails each cell's limits, at the cells' widths and a
frame size a CPU test holds; the limits themselves were set from
readings at the cells' own sizes on the card (``calibrate.py``)."""

import json

import numpy as np
import pytest
import torch

from portbench import harness, seeded
from portbench.reference import train as ref_train
from portbench.reference import upscaler as ref
from portbench.traffic.stream import compare


def _cell(name):
    cell = json.loads((harness.BENCH_DIR / "workloads" / f"{name}.json").read_text())
    config = json.loads((harness.BENCH_DIR / "configs" / f"{cell['config']}.json").read_text())
    return config, {k: v["limit"] for k, v in cell["checks"].items()}


@pytest.mark.parametrize("name", ["x2-1080p-stream", "x4-540p-stream"])
@pytest.mark.parametrize("seed", [2**31 + 5, 2**31 + 6])
def test_control_fails_a_serving_cells_limits(name, seed):
    config, limits = _cell(name)
    weights = seeded.weights(config, seed, "cpu")
    planes = seeded.frames(1, 48, 64, 2, seed + 1, "cpu")
    want = [p[0].numpy() for p in ref.upscale(weights, *planes, config["scale"], config["depth"])]
    got = [p[0].numpy() for p in ref.upscale(weights, *planes, config["scale"],
                                             config["depth"], "fp8")]
    gaps = compare(got, want)
    assert any(gaps[k] > limits[k] for k in gaps), gaps


@pytest.mark.parametrize("seed", [2**31 + 7, 2**31 + 8])
def test_control_fails_the_training_cells_limits(seed):
    config, limits = _cell("x2-train-720p")
    weights = seeded.weights(config, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    batches = []
    for _ in range(3):
        hr = torch.rand((8, 64, 64, 3), generator=gen).numpy()
        batches.append((ref_train.box_downsample(hr, 2).astype(np.float32), hr))
    want = ref_train.steps(weights, batches, 2, config["depth"], 1e-3)
    got = ref_train.steps(weights, batches, 2, config["depth"], 1e-3, "fp8")
    counted = ref_train.counted_leaves(want[1])
    gaps = {
        "loss_gap": max(abs(a - b) / b for a, b in zip(got[0], want[0])),
        "grad_gap": ref_train.leaf_gap(got[1], want[1], counted),
        "change_gap": ref_train.leaf_gap({k: got[2][k] - weights[k] for k in counted},
                                         {k: want[2][k] - weights[k] for k in counted},
                                         counted),
    }
    assert any(gaps[k] > limits[k] for k in gaps), gaps
