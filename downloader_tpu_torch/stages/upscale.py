"""Upscale stage: run staged media frames through the super-resolution
model between ``process`` and ``upload``, on the port's engine.

The port of ``downloader_tpu/stages/upscale.py``: the same stage, with
the JAX engine replaced by the port's
:class:`~downloader_tpu_torch.compute.pipeline.FrameUpscaler` (bf16 convs
on cuDNN, the s2d tail as a hand-written CUDA kernel).  The reference
pipeline has no compute stage — its downstream "converter" service does
the media transform (upstream lib/main.js:157-167 just hands the job
over).  This stage is the config-gated, in-pipeline version of that
converter workload: decoded frames go through the engine and the
upscaled stream replaces the original in the upload set.

Gating and scope, as in the reference:

- Enabled only when ``config.instance.upscale.enabled`` is true; the
  default pipeline stays byte-for-byte reference-parity
  (download -> process -> upload).
- Raw Y4M streams (sniffed by content magic, not extension — see
  :func:`~downloader_tpu_torch.compute.video.sniff_y4m`) are transformed
  directly.  Compressed containers go through the config-gated decode
  front-end (``instance.upscale.decode`` / ``decoder``) and, mirror
  image, the encode back-end (``encode`` / ``encoder`` / ``encode_args``
  / ``container``); both are feature-detected
  (:mod:`..compute.transcode`).
- The engine (model + params on the device) is memoized in
  ``ctx.resources`` so every job in the process shares one copy of the
  params on the card; concurrent jobs (``instance.max_concurrent_jobs``)
  run on it from their own worker threads.

What differs from the reference, all in ``instance.upscale``:

- ``device``: ``cuda`` (the default) or ``cpu``.  Without a card and
  without ``cpu`` the engine's construction raises; it runs inside the
  ``compute.upscale`` Retrier seam, so the job fails through the retries
  and the ``compute`` breaker, as a wedged chip does in the reference.
  There is no fallback to the CPU.
- ``use_mesh`` (the default) spreads each batch over every visible card,
  as the reference's engine spans every device; on the CPU there is one
  device.
- ``donate`` is read and is a no-op: buffer donation has no meaning in
  eager PyTorch.
- ``model``: ``espcn`` (the default, the ESPCN-style upscaler that
  ``scale``/``features``/``depth`` shape) or ``swinir-m-x4-real``
  (SwinIR-M x4 real-world, :mod:`..compute.models.swinir`): served only,
  so it takes no ``checkpoint``; outputs are named ``.4x``.
- ``checkpoint`` names a directory written by the port's own ``train``
  or by the JAX package's (its orbax steps, read by the port's
  ``restore_state``); a step it cannot read raises the ``ValueError``
  that names the format.

Stage contract: consumes ``{files, downloadPath}`` from process
(lib/process.js:117-120 shape), returns the same shape with upscaled
paths substituted, so ``upload`` runs unchanged.
"""

from __future__ import annotations

import asyncio
import os
import shutil
import threading

from ..platform import faults
from ..platform.errors import Retrier
from .base import Job, StageContext, StageFn

_ENGINE_KEY = "upscale.engine"
_ENGINE_LOCK = threading.Lock()  # _get_engine runs in worker threads

# containers the decode front-end will attempt — exactly the set the
# process stage selects as media (one source of truth; reference
# lib/process.js:15-20)
from .process import MEDIA_EXTS as _DECODE_EXTS  # noqa: E402


def _device(value) -> str:
    """``instance.upscale.device``: ``cuda`` or ``cpu``; anything else
    fails the stage's load, at boot."""
    device = str(value)
    if device not in ("cuda", "cpu"):
        raise ValueError(
            f"instance.upscale.device must be 'cuda' or 'cpu', got {device!r}")
    return device


def _model(value) -> str:
    """``instance.upscale.model``: one of :data:`..compute.models.MODELS`;
    anything else fails the stage's load, at boot."""
    from ..compute.models import MODELS

    model = str(value)
    if model not in MODELS:
        raise ValueError(f"instance.upscale.model must be one of "
                         f"{', '.join(MODELS)}, got {model!r}")
    return model


def _engine_config(config):
    """Read ``instance.upscale.*`` with safe defaults."""
    from ..platform.config import cfg_get

    def opt(key, default):
        return cfg_get(config, f"instance.upscale.{key}", default)

    from ..compute.transcode import DEFAULT_ENCODE_ARGS

    return {
        # scale, features and depth shape the espcn model only
        "model": _model(opt("model", "espcn")),
        "scale": int(opt("scale", 2)),
        "features": int(opt("features", 128)),
        "depth": int(opt("depth", 4)),
        "batch": int(opt("batch", 8)),
        "checkpoint": opt("checkpoint", None),
        "use_mesh": bool(opt("use_mesh", True)),
        # read for the reference's config surface; a no-op in eager
        # PyTorch, which has no buffer donation
        "donate": bool(opt("donate", False)),
        "device": _device(opt("device", "cuda")),
        "decode": bool(opt("decode", False)),
        "decoder": str(opt("decoder", "ffmpeg")),
        "encode": bool(opt("encode", False)),
        "encoder": str(opt("encoder", "ffmpeg")),
        "encode_args": [str(a) for a in opt("encode_args",
                                            list(DEFAULT_ENCODE_ARGS))],
        "container": str(opt("container", "mkv")).lstrip("."),
    }


def _model_config(opts):
    """The selected model's configuration (its ``scale`` names outputs)."""
    from ..compute.models import model_config

    return model_config(opts["model"], scale=opts["scale"],
                        features=opts["features"], depth=opts["depth"])


def upscale_enabled(config) -> bool:
    """True when ``instance.upscale.enabled`` is set (app.py gating)."""
    from ..platform.config import cfg_get

    return bool(cfg_get(config, "instance.upscale.enabled", False))


def _get_engine(ctx: StageContext):
    """Build (once per process) the shared FrameUpscaler."""
    with _ENGINE_LOCK:  # concurrent jobs must share one engine/params copy
        engine = ctx.resources.get(_ENGINE_KEY)
        if engine is None:
            from ..compute.pipeline import FrameUpscaler

            opts = _engine_config(ctx.config)
            engine = FrameUpscaler(
                config=_model_config(opts),
                batch=opts["batch"],
                checkpoint_dir=opts["checkpoint"],
                use_mesh=opts["use_mesh"],
                device=opts["device"],
            )
            ctx.resources[_ENGINE_KEY] = engine
    return engine


async def stage_factory(ctx: StageContext) -> StageFn:
    logger = ctx.logger
    opts = _engine_config(ctx.config)
    # chip calls ride the service's shared retry executor + a "compute"
    # circuit breaker of their own (same board as store/publish/http, so
    # a wedged device shows up beside a hard-down backend on /readyz)
    retrier = Retrier.shared(ctx.resources, ctx.config,
                             metrics=ctx.metrics, logger=ctx.logger)

    async def upscale(job: Job):
        from ..compute.transcode import transcode
        from ..compute.video import sniff_y4m

        if ctx.record is not None:
            # upscale jobs are their own SLO class (control/slo.py
            # WORKLOAD_CLASSES): the settle seam feeds the UPSCALE
            # objective alongside the priority class's
            ctx.record.workload = "UPSCALE"

        last = job.last_stage
        files = last["files"] if isinstance(last, dict) else last.files
        download_path = (
            last["downloadPath"] if isinstance(last, dict) else last.downloadPath
        )

        out_files = []
        with ctx.tracer.span("stage.upscale", files=len(files)):
            for path in files:
                header = sniff_y4m(path)
                decoder = None
                if header is None:
                    ext = os.path.splitext(path)[1].lower()
                    if opts["decode"] and ext in _DECODE_EXTS:
                        # graftlint: disable=blocking-call-in-async -- which() is ~10 PATH stats, once per file
                        decoder = shutil.which(opts["decoder"])
                        if decoder is None:
                            logger.warn(
                                "decoder not available; passing through",
                                decoder=opts["decoder"],
                                path=os.path.basename(path),
                            )
                    if decoder is None:
                        logger.info(
                            "passing through non-y4m media",
                            path=os.path.basename(path),
                        )
                        out_files.append(path)
                        continue
                encoder = None
                if opts["encode"]:
                    # graftlint: disable=blocking-call-in-async -- which() is ~10 PATH stats, once per file
                    encoder = shutil.which(opts["encoder"])
                    if encoder is None:
                        # weaker fallback than decode's passthrough: the
                        # upscale still runs, output is raw y4m (the
                        # pre-encode behavior) — staged oversized but valid
                        logger.warn(
                            "encoder not available; writing raw y4m",
                            encoder=opts["encoder"],
                            path=os.path.basename(path),
                        )
                scale = _model_config(opts).scale  # the engine's
                stem, ext = os.path.splitext(path)
                # the FULL source name stays in transformed dsts so
                # movie.mkv and movie.mp4 in one job cannot collide on
                # one output.  Direct y4m input without encode keeps its
                # extension (the output is still y4m).
                if encoder is not None:
                    dst = f"{path}.{scale}x.{opts['container']}"
                elif decoder is not None:
                    dst = f"{path}.{scale}x.y4m"
                else:
                    dst = f"{stem}.{scale}x{ext}"
                logger.info(
                    "upscaling",
                    path=os.path.basename(path),
                    size=(f"{header.width}x{header.height}" if header
                          else "compressed"),
                    scale=scale,
                    decoded=decoder is not None,
                    encoded=encoder is not None,
                )
                # the device work holds the GIL only between dispatches;
                # running in a thread keeps heartbeats/telemetry flowing.
                # No cleanup here: transcode writes through a temp and
                # renames on success, so on failure dst either doesn't
                # exist or is a COMPLETE output from a prior attempt —
                # which a redelivered job should keep, not delete.
                record = ctx.record

                def _run_transcode(engine, src=path, out=dst, dec=decoder,
                                   enc=encoder):
                    # bind the job's hop ledger to the engine for this
                    # worker thread: the h2d/compute/d2h hops billed
                    # inside the dispatch/fetch path land on THIS job
                    if record is not None and record.hops is not None:
                        with engine.hop_sink.bound(record.note_hop):
                            return transcode(
                                engine, src, out, decoder=dec, encoder=enc,
                                encode_args=opts["encode_args"])
                    return transcode(engine, src, out, decoder=dec,
                                     encoder=enc,
                                     encode_args=opts["encode_args"])

                async def _compute(src=path):
                    if faults.enabled():
                        await faults.fire("compute.upscale",
                                          key=os.path.basename(src))
                    # engine construction is model init + a copy of the
                    # params to the card — and raises without one — so it
                    # runs off the event loop, inside the seam: a missing
                    # card fails through the retries and the compute
                    # breaker like any other compute fault
                    engine = await asyncio.to_thread(_get_engine, ctx)
                    return await asyncio.to_thread(_run_transcode, engine)

                frames = await retrier.run(
                    "compute.upscale", _compute, cancel=ctx.cancel,
                    record=ctx.record, logger=logger)
                logger.info(
                    "upscaled", path=os.path.basename(dst), frames=frames
                )
                if ctx.record is not None:
                    ctx.record.event("upscale", frames=frames,
                                     file=os.path.basename(dst))
                if ctx.metrics is not None and hasattr(
                    ctx.metrics, "frames_upscaled"
                ):
                    ctx.metrics.frames_upscaled.inc(frames)
                # separate guard: the duck-typing contract protects the
                # attributes actually used (an embedder's metrics object
                # may predate these counters)
                if (ctx.metrics is not None
                        and hasattr(ctx.metrics, "transcode_bytes_in")
                        and hasattr(ctx.metrics, "transcode_bytes_out")):
                    ctx.metrics.transcode_bytes_in.inc(
                        os.path.getsize(path))
                    ctx.metrics.transcode_bytes_out.inc(
                        os.path.getsize(dst))
                out_files.append(dst)

        return {"files": out_files, "downloadPath": download_path}

    return upscale
