"""A run with the timed path broken underneath comes out not correct:
each fault the cells can have, planted in the program, on the CPU
rehearsal path at a tiny size, held to the real cells' limits."""

import pytest

from portbench import faults
from portbench.tests import tiny

CELLS = {
    "x2-1080p-stream": ("half_batch", "altered_answer", "exchange_left_out"),
    "x4-540p-stream": ("half_batch", "altered_answer"),
    "x2-train-720p": ("unchanged_state", "half_batch"),
}
CASES = [(cell, fault) for cell, planted in CELLS.items() for fault in planted]
# the exchange between cards: a batch of 4 in four shards, the last left out
SHARDS = {"exchange_left_out": 4}


def _tiny(tmp_path, cell, shards=1):
    bench = tiny.bench_copy(tmp_path)
    traffic = tiny.TRAIN_TRAFFIC if "train" in cell else tiny.SERVE_TRAFFIC
    config = dict(tiny.SERVE_CONFIG, batch=max(2, shards))
    tiny.add_cell(bench, "tiny", cell, config, traffic)
    return bench


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(tmp_path, cell):
    bench = _tiny(tmp_path, cell)
    rc, line, err = tiny.run(bench, "tiny", seed=2**31 + 77)
    assert rc == 0, err
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell, fault", CASES)
def test_planted_fault_is_not_correct(tmp_path, cell, fault):
    shards = SHARDS.get(fault, 1)
    bench = _tiny(tmp_path, cell, shards)
    with faults.planted(fault, shards=shards):
        rc, line, err = tiny.run(bench, "tiny", seed=2**31 + 78)
    assert rc == 0, err
    assert not line["correct"], line["checks"]
