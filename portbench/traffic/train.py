"""Traffic driver ``train``: ``downloader_tpu_torch.compute.trainer.train``
on a seeded 4:2:0 Y4M clip, the path of the ``train`` CLI.

Parameters (the traffic's file): ``width``, ``height``, ``frames`` of the
clip (written under ``TMPDIR``), ``batch``, ``crop``, ``learning_rate``,
``warm_steps`` (the steps before the window opens) and ``checked_steps``
(of those, the ones the reference follows).

One ``train()`` call is set-up and window both.  The harness swaps
``trainer.compile_train_step`` for a wrapper, so the call's training
state (the model with the benchmark's weights and its Adam state) is
the one the comparison reads: its first steps' losses, its first
gradient (from Adam's first moment after step 1) and its change after
the checked steps, which the reference recomputes from the crops it
draws again.  After ``warm_steps`` steps the wrapper opens the window;
steps whose call returned within ``seconds`` of it count, and the
wrapper ends the call at its next step.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import seeded
from portbench.harness import Check, Outcome
from portbench.reference import train as reference


class WindowClosed(Exception):
    """Raised by the step wrapper to end the window's ``train()`` call."""


def write_clip(path: str, planes) -> None:
    y, cb, cr = planes
    n, h, w = y.shape
    with open(path, "wb") as fh:
        fh.write(f"YUV4MPEG2 W{w} H{h} F30:1 Ip A1:1 C420jpeg\n".encode())
        for i in range(n):
            fh.write(b"FRAME\n")
            for p in (y, cb, cr):
                fh.write(p[i].tobytes())


class Stepper:
    """The wrapper around ``compile_train_step``: one state, the checked
    steps' losses and state kept, the window opened after the warm-up."""

    def __init__(self, ctx, weights, checked: int, warm: int, compile_train_step):
        self.ctx, self.weights, self.checked, self.warm = ctx, weights, checked, warm
        self.compile = compile_train_step
        self.state = None
        self.opened = self.close_at = None
        self.n = 0
        self.losses, self.first_moment, self.after = [], None, None
        self.steps: list = []   # (entered, returned) of each step call

    def __call__(self, config, *args, **kwargs):
        step, init_state, decision = self.compile(config, *args, **kwargs)

        def init(seed):
            self.state = init_state(seed)
            with torch.no_grad():
                self.state.model.load_state_dict(self.weights)
            return self.state

        def timed(state, low, high):
            entered = time.monotonic()
            if self.close_at is not None and entered >= self.close_at:
                raise WindowClosed
            with self.ctx.tracer.span("host.step"):
                loss = step(state, low, high)
            self.n += 1
            if self.n <= self.checked:
                self._keep(state, loss)
            self.steps.append((entered, time.monotonic()))
            if self.n == self.warm:
                self._open()
            return loss

        return timed, init, decision

    def _keep(self, state, loss) -> None:
        self.losses.append(loss.detach().clone())
        if self.n == 1:
            # a parameter Adam never took has no moment: zero
            self.first_moment = {
                k: state.optimizer.state[p].get("exp_avg", torch.zeros_like(p))
                .detach().clone() for k, p in state.model.named_parameters()}
        if self.n == self.checked:
            self.after = {k: p.detach().clone()
                          for k, p in state.model.named_parameters()}

    def _open(self) -> None:
        if self.ctx.device == "cuda":
            torch.cuda.synchronize()
        self.ctx.mark("warm-up")
        self.opened = self.ctx.window_open = time.monotonic()
        self.close_at = self.opened + self.ctx.seconds
        self.ctx.tracer.open()


def _crop_spans(tracer, stream):
    def traced(*args, **kwargs):
        it = stream(*args, **kwargs)
        while True:
            with tracer.span("host.crop_stream"):
                item = next(it)
            yield item

    return traced


def run(ctx) -> Outcome:
    from downloader_tpu_torch.compute import trainer

    config, traffic = ctx.config, ctx.traffic
    ctx.mark("imports")
    weights = seeded.weights(config, ctx.seed, ctx.device)
    clip_planes = [p.cpu().numpy() for p in seeded.frames(
        traffic["frames"], traffic["height"], traffic["width"], 2, ctx.seed + 1, ctx.device)]
    ctx.mark("inputs")
    workdir = tempfile.mkdtemp(prefix="portbench-train-")
    try:
        clip = os.path.join(workdir, "clip.y4m")
        write_clip(clip, clip_planes)
        del clip_planes
        ctx.mark("clip written")
        return _run(ctx, trainer, weights, clip)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(ctx, trainer, weights, clip) -> Outcome:
    config, traffic = ctx.config, ctx.traffic
    if traffic["warm_steps"] < traffic["checked_steps"]:
        raise ValueError("the window opens after the checked steps")
    stepper = Stepper(ctx, weights, traffic["checked_steps"], traffic["warm_steps"],
                      trainer.compile_train_step)
    settings = trainer.TrainerSettings(
        steps=10**12, batch=traffic["batch"], crop=traffic["crop"],
        learning_rate=traffic["learning_rate"], seed=ctx.seed % 2**63,
        scale=config["scale"], features=config["features"], depth=config["depth"])

    originals = (trainer.compile_train_step, trainer.hr_crop_stream)
    trainer.compile_train_step = stepper
    if ctx.trace:
        trainer.hr_crop_stream = _crop_spans(ctx.tracer, trainer.hr_crop_stream)
    ctx.tracer.start()
    try:
        try:
            trainer.train([clip], settings, device=ctx.device)
        except WindowClosed:
            pass
        ctx.tracer.close()
    finally:
        ctx.tracer.stop()
        trainer.compile_train_step, trainer.hr_crop_stream = originals
    window = stepper.close_at - stepper.opened
    done = [s for s in stepper.steps[stepper.warm:] if s[1] <= stepper.close_at]
    peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    readings = {"steps": len(done), "window_s": window,
                "data_ms": [1e3 * (b[0] - a[1]) for a, b in zip(done, done[1:])]}
    losses = [float(x) for x in stepper.losses]
    first_grads = {k: m / (1 - reference.BETA1) for k, m in stepper.first_moment.items()}
    after, attempted = stepper.after, stepper.n
    stepper.state = None
    del stepper
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    batches = reference_batches(ctx, clip)
    detail: dict = {}
    gaps = judge(ctx, weights, batches, losses, first_grads, after, detail=detail)
    readings["compare_detail"] = detail
    return Outcome(
        metrics={"train_steps_per_s": (len(done) / window, "steps/s")},
        attempted=attempted, failed=0,
        checks=[Check(k, v, ctx.limits[k]) for k, v in gaps.items()],
        memory_peak_bytes=peak, readings=readings,
        control=lambda precision: judge(ctx, weights, batches, None, None, None, precision))


def reference_batches(ctx, clip):
    """The checked steps' (low-res, high-res) batches, drawn again."""
    t = ctx.traffic
    hr = reference.crops(clip, t["crop"], ctx.seed % 2**63, t["checked_steps"] * t["batch"])
    return [(reference.box_downsample(b, ctx.config["scale"]).astype(np.float32), b)
            for b in hr.reshape(t["checked_steps"], t["batch"], *hr.shape[1:])]


def judge(ctx, weights, batches, losses, first_grads, after, precision=None,
          detail=None) -> dict:
    """The checked steps against the plain reference: the worst relative
    loss gap, and by the worst leaf the gap of the first gradient's norm
    and of the parameters' change after the checked steps.  With
    ``precision`` the control's steps stand in the program's place."""
    config = ctx.config
    run_ref = lambda p: reference.steps(weights, batches, config["scale"], config["depth"],  # noqa: E731
                                        ctx.traffic["learning_rate"], p)
    want_losses, want_grads, want_after = run_ref(None)
    if precision is not None:
        losses, first_grads, after = run_ref(precision)
    counted = reference.counted_leaves(want_grads)
    change = {k: after[k].float() - weights[k] for k in counted}
    want_change = {k: want_after[k] - weights[k] for k in counted}
    if detail is not None:
        detail.update(losses=list(zip(losses, want_losses)),
                      grad=reference.leaf_gaps(first_grads, want_grads, counted),
                      change=reference.leaf_gaps(change, want_change, counted))
    return {
        "loss_gap": max(abs(a - b) / b for a, b in zip(losses, want_losses)),
        "grad_gap": reference.leaf_gap(first_grads, want_grads, counted),
        "change_gap": reference.leaf_gap(change, want_change, counted),
    }
