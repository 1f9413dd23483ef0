"""Traffic driver ``stream_arch``: the ``stream`` driver's path (one
endless 4:2:0 Y4M stream through ``FrameUpscaler.upscale_to``, the path of
the ``upscale`` CLI and stage) for a configuration that names its
architecture (``"arch"``) and its plain reference (``"reference"``, a
file of the benchmark).  The source, the sink, the traced run's wrappers
and the comparison are ``stream``'s; the traffic's parameters are too.

What differs is the model's configuration, its seeded weights, the
reference the sample is judged against (:data:`ARCHS`) and the rate:
``frames_per_s`` counts the frames of the whole batches whose last byte
reached the sink inside the window, over the time from the window's
opening to that last frame's arrival.  The window opens at a batch's
last frame, so the rate spans whole batch periods: at a batch or so a
second, counting frames that arrive before the window closes would move
the rate in steps of a batch (one in ~20), far above its bound.
``frame_latency_p95_ms`` is ``stream``'s.

Weights follow SwinIR's own init (``models/network_swinir.py``):
linear kernels and the relative-position bias tables normal with std
0.02 (cut at two deviations), LayerNorm (1, 0), convs PyTorch's default
(uniform within 1/sqrt(fan_in)); the biases are seeded small
(``bias_std``).  ``conv_last``'s 3x3 taps are centred for each pair of
output and input channels and scaled by ``head_gain`` (both
``assumed`` in the configuration): with the default init the output's
offset from the RGB mean grows with the gain as fast as its spread, so
no gain keeps every seed's output both spread and unclipped; centred,
the output keeps the model's mean and the gain sets only its spread.
"""

from __future__ import annotations

import gc
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import harness, seeded
from portbench.harness import Check, Outcome
from portbench.traffic.stream import (Sink, Source, _Traced, compare, header, p95,
                                      peak_memory)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def swinir_config(config: dict):
    from downloader_tpu_torch.compute.models.swinir import SwinIRConfig

    return SwinIRConfig(
        scale=config["scale"], in_chans=config["in_chans"],
        embed_dim=config["embed_dim"], depths=tuple(config["depths"]),
        num_heads=tuple(config["num_heads"]), window_size=config["window_size"],
        mlp_ratio=config["mlp_ratio"], num_feat=config["num_feat"],
        upsampler=config["upsampler"], img_range=config["img_range"],
        rgb_mean=tuple(config["rgb_mean"]),
        param_dtype=_DTYPES[config["param_dtype"]],
        compute_dtype=_DTYPES[config["compute_dtype"]])


def swinir_shapes(config: dict) -> Dict[str, tuple]:
    """Every parameter's official name and shape, in the official order."""
    c, f, ch, w = config["embed_dim"], config["num_feat"], config["in_chans"], \
        config["window_size"]
    hidden = int(c * config["mlp_ratio"])

    def conv(name, c_out, c_in):
        return {f"{name}.weight": (c_out, c_in, 3, 3), f"{name}.bias": (c_out,)}

    def pair(name, shape_w, n_out):
        return {f"{name}.weight": shape_w, f"{name}.bias": (n_out,)}

    shapes = dict(conv("conv_first", c, ch), **pair("patch_embed.norm", (c,), c))
    for i, (depth, heads) in enumerate(zip(config["depths"], config["num_heads"])):
        for j in range(depth):
            p = f"layers.{i}.residual_group.blocks.{j}"
            shapes.update(pair(f"{p}.norm1", (c,), c))
            shapes[f"{p}.attn.relative_position_bias_table"] = ((2 * w - 1) ** 2, heads)
            shapes.update(pair(f"{p}.attn.qkv", (3 * c, c), 3 * c))
            shapes.update(pair(f"{p}.attn.proj", (c, c), c))
            shapes.update(pair(f"{p}.norm2", (c,), c))
            shapes.update(pair(f"{p}.mlp.fc1", (hidden, c), hidden))
            shapes.update(pair(f"{p}.mlp.fc2", (c, hidden), c))
        shapes.update(conv(f"layers.{i}.conv", c, c))
    shapes.update(pair("norm", (c,), c))
    shapes.update(conv("conv_after_body", c, c))
    shapes.update(conv("conv_before_upsample.0", f, c))
    for name in ("conv_up1", "conv_up2", "conv_hr"):
        shapes.update(conv(name, f, f))
    shapes.update(conv("conv_last", ch, f))
    return shapes


def _kind(name: str, shape: tuple) -> str:
    if "norm" in name.rsplit(".", 2)[-2]:
        return "one" if name.endswith(".weight") else "zero"
    if name.endswith(".bias"):
        return "bias"
    return "conv" if len(shape) == 4 else "normal"


def swinir_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights under the official names, from ``seed`` (module
    docstring), drawn in two calls on the device."""
    shapes = swinir_shapes(config)
    kinds = {n: _kind(n, s) for n, s in shapes.items()}
    g = seeded.generator(seed, device)
    normal = [n for n in shapes if kinds[n] in ("normal", "bias")]
    uniform = [n for n in shapes if kinds[n] == "conv"]
    sizes = {n: math.prod(s) for n, s in shapes.items()}
    drawn = dict(zip(normal, torch.randn(sum(sizes[n] for n in normal), generator=g,
                                         device=device).split([sizes[n] for n in normal])))
    drawn.update(zip(uniform, torch.rand(sum(sizes[n] for n in uniform), generator=g,
                                         device=device).split([sizes[n] for n in uniform])))
    out = {}
    for name, shape in shapes.items():
        kind = kinds[name]
        if kind == "one":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "bias":
            out[name] = drawn[name].view(shape) * config["bias_std"]
        elif kind == "normal":
            out[name] = drawn[name].view(shape).clamp(-2.0, 2.0) * 0.02
        else:
            bound = 1.0 / math.sqrt(math.prod(shape[1:]))
            out[name] = (drawn[name].view(shape) * 2.0 - 1.0) * bound
    last = out["conv_last.weight"]
    out["conv_last.weight"] = (last - last.mean(dim=(2, 3), keepdim=True)) * config["head_gain"]
    return out


# arch -> (the program's configuration, the seeded weights)
ARCHS = {"swinir": (swinir_config, swinir_weights)}


class BatchSink(Sink):
    """``stream``'s sink, noting when each whole batch of the window has
    arrived: (frames counted so far, arrival of the batch's last frame)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.batch_ends: List[tuple] = []

    def _frame_done(self, now: float) -> None:
        counted = self.in_window
        super()._frame_done(now)
        if self.in_window > counted and self.done % self._batch == 0:
            self.batch_ends.append((self.in_window, now))


def _planes_of(data, y_shape, c_shape):
    y, cb, cr = data
    return (np.frombuffer(y, np.uint8).reshape(y_shape),
            np.frombuffer(cb, np.uint8).reshape(c_shape),
            np.frombuffer(cr, np.uint8).reshape(c_shape))


def judge(ctx, reference, weights, pool, sample, precision=None,
          detail: Optional[list] = None) -> dict:
    """The worst gaps over the sampled frames between what was produced
    and the plain reference (``precision="fp8"``: the control's output in
    the program's place); ``detail`` receives each frame's gaps, its
    share of clipped reference values and its reference luma's spread."""
    config, traffic = ctx.config, ctx.traffic
    h, w, r = traffic["height"], traffic["width"], config["scale"]
    y_shape, c_shape = (h * r, w * r), (h * r // 2, w * r // 2)
    worst = {"worst_mae": 0.0, "worst_step": 0.0}
    for index, data in sample:
        planes = [p[index % len(pool[0])][None].to(ctx.device) for p in pool]
        want = [p[0].cpu().numpy() for p in reference.upscale(weights, *planes, config)]
        if precision is None:
            got = _planes_of(data, y_shape, c_shape)
        else:
            got = [p[0].cpu().numpy() for p in reference.upscale(
                weights, *planes, config, precision)]
        gaps = compare(got, want)
        for key, value in gaps.items():
            worst[key] = max(worst[key], value)
        if detail is not None:
            clipped = float(np.mean([((p == 0) | (p == 255)).mean() for p in want]))
            detail.append(dict(gaps, frame=index, clipped=clipped,
                               luma_std=float(want[0].std())))
    return worst


def run(ctx) -> Outcome:
    make_config, make_weights = ARCHS[ctx.config["arch"]]
    program_config = make_config(ctx.config)
    from downloader_tpu_torch.compute.pipeline import FrameUpscaler

    config, traffic = ctx.config, ctx.traffic
    reference = harness.load_module(harness.ROOT / config["reference"])
    h, w, r = traffic["height"], traffic["width"], config["scale"]
    ctx.mark("imports")
    weights = make_weights(config, ctx.seed, ctx.device)
    pool = seeded.frames(traffic["pool"], h, w, 2, ctx.seed + 1, ctx.device)
    pool_host = [p.cpu().numpy() for p in pool]
    frames = [b"".join(p[i].tobytes() for p in pool_host) for i in range(traffic["pool"])]
    ctx.mark("inputs")
    engine = FrameUpscaler(program_config, batch=config["batch"], params=weights,
                           device=ctx.device, use_mesh=config["use_mesh"])
    ctx.mark("engine")
    batch = engine.batch_for(h, w)
    source = Source(header(w, h), frames, batch, ctx.tracer)
    sizes = (h * r * w * r, h * r * w * r // 4, h * r * w * r // 4)
    sink = BatchSink(ctx, header(w * r, h * r), sizes, traffic["warm_batches"] * batch,
                     source, batch, traffic["sample_per_row"])
    traced = _Traced(ctx, engine) if ctx.trace else None
    ctx.tracer.start()
    try:
        if traced is not None:
            with engine.hop_sink.bound(traced.note):
                engine.upscale_to(source, sink, depth=traffic["depth"])
        else:
            engine.upscale_to(source, sink, depth=traffic["depth"])
        if sink.closed is None:
            sink.closed = sink.closed_at
        readings = {} if traced is None else traced.readings(sink.opened, sink.closed)
    finally:
        ctx.tracer.stop()
        if traced is not None:
            traced.restore()
    if not sink.batch_ends:
        raise RuntimeError("no whole batch arrived inside the window")
    counted, last = sink.batch_ends[-1]
    span = last - sink.opened
    frames_lost = len(source.read_at) - sink.done
    peak = peak_memory(ctx)
    del engine, traced
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    sample = sink.sample
    detail: list = []
    gaps = judge(ctx, reference, weights, pool, sample, detail=detail)
    readings["compare_detail"] = detail
    checks = [Check("frames_lost", float(frames_lost), ctx.limits["frames_lost"]),
              Check("stream_malformed", float(sink.malformed), ctx.limits["stream_malformed"]),
              Check("sample_short", float(batch * traffic["sample_per_row"] - len(sample)),
                    ctx.limits["sample_short"])]
    checks += [Check(k, v, ctx.limits[k]) for k, v in gaps.items()]
    readings.update(frames=counted, window_s=span, batch=batch)
    return Outcome(
        metrics={"frames_per_s": (counted / span, "frames/s"),
                 "frame_latency_p95_ms": (1e3 * p95(sink.latencies), "ms")},
        attempted=len(source.read_at), failed=frames_lost + sink.malformed,
        checks=checks, memory_peak_bytes=peak, readings=readings,
        control=lambda precision: judge(ctx, reference, weights, pool, sample, precision))
