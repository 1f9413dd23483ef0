"""Faults planted under the timed path, to show that the comparison
catches them (``tests/test_portbench_faults.py`` on the CPU) and to read
what they give at a cell's own size (``calibrate.py --fault`` on the
card).  Each patches the program for the duration of a ``with`` block.

- ``unchanged_state``: the train step computes its loss and gradients
  but leaves the parameters and Adam's state as they were;
- ``half_batch``: half of the batch is left out; the train step takes
  its mean over the rest, the engine fills the missing frames' rows
  with the first half's outputs;
- ``altered_answer``: the last frame of every batch comes out with its
  luma mirrored left to right, where the engine produces it;
- ``exchange_left_out``: the last of ``shards`` shards' rows of every
  batch never come back from its card (zeros), the exchange between
  cards left out.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged_state", "half_batch", "altered_answer", "exchange_left_out")


@contextlib.contextmanager
def planted(name: str, shards: int = 1):
    from downloader_tpu_torch.compute import train
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; known: {', '.join(FAULTS)}")
    saved_make, saved_core, saved_fetch = (train.make_train_step, FrameUpscaler._core,
                                           FrameUpscaler._fetch)

    def make_train_step(*args, **kwargs):
        step, init_state = saved_make(*args, **kwargs)

        def faulty(state, low, high):
            if name == "half_batch":
                half = low.shape[0] // 2
                return step(state, low[:half], high[:half])
            if name == "unchanged_state":
                update = state.optimizer.step
                state.optimizer.step = lambda *a, **k: None
                try:
                    return step(state, low, high)
                finally:
                    state.optimizer.step = update
            return step(state, low, high)

        return faulty, init_state

    def core(self, y, cb, cr, sub_h, sub_w):
        if name == "half_batch" and y.shape[0] > 1:
            half = (y.shape[0] + 1) // 2
            out = saved_core(self, y[:half], cb[:half], cr[:half], sub_h, sub_w)
            return tuple(torch.cat([p, p[:y.shape[0] - half]]) for p in out)
        out = saved_core(self, y, cb, cr, sub_h, sub_w)
        if name == "altered_answer":
            luma = out[0].clone()
            luma[-1] = luma[-1].flip(-1)
            return (luma, *out[1:])
        return out

    def fetch(self, handle):
        planes = saved_fetch(self, handle)
        if name != "exchange_left_out":
            return planes
        rows = planes[0].shape[0]
        return tuple(_zero_rows(p, rows - max(1, rows // shards)) for p in planes)

    train.make_train_step, FrameUpscaler._core, FrameUpscaler._fetch = (
        make_train_step, core, fetch)
    try:
        yield
    finally:
        train.make_train_step, FrameUpscaler._core, FrameUpscaler._fetch = (
            saved_make, saved_core, saved_fetch)


def _zero_rows(plane, start: int):
    out = plane.copy()
    out[start:] = 0
    return out
