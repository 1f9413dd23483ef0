"""Batched frame-upscaling engine: planar YCbCr in, planar YCbCr out —
the port of ``downloader_tpu/compute/pipeline.py``'s ``FrameUpscaler``.

Every branch of the reference's ``core`` (``pipeline.py:232-261``) runs:

- the main path (chroma subsampling == scale, even frame dims): u8 planes
  -> chroma upsample + YCbCr->unit-RGB -> the bf16 trunk (cuDNN) -> the
  packed stride-2 s2d head (cuDNN) -> the fused s2d tail (a hand-written
  CUDA kernel, all three quantizes inline) -> u8 planes;
- odd frame dims at subsampling == scale (e.g. scale 1 on 4:4:4): the
  plain 3x3 head, then :func:`~.ops.colorspace.fused_subpixel_ycc`;
- ``sub != scale`` (4:2:2 and 4:4:4 at scale 2): the generic tail — the
  full forward, RGB->YCbCr, chroma downsample and three standalone
  quantizes.

The tails' quantizes launch the CUDA kernels on the card, at every
scale.

Spatial tiling (the reference's ``:42-122``, ``:263-327``) folds halo'd
tiles of very large frames into the batch dim when ``PIXEL_BUDGET``
starves the dispatch batch below ``TARGET_FRAMES`` (4K at batch 2 runs as
32 tiles of 556x976), runs the branch above on them and stitches the
kept regions.  The halo covers the receptive radius and the outer tiles
sit on the frame edges, so the result is the untiled one.

PyTorch runs eagerly, so on one device the reference's static-shape
padding of the last short batch is not needed: every batch runs at its
own size and the returned shapes match the reference's.  The tiling
decision is still taken on the padded size the reference would dispatch
(:meth:`FrameUpscaler.batch_for`), so a short last batch tiles like the
others.

Devices (the reference's ``:192-219``): with ``use_mesh`` (the default)
an engine on CUDA adopts every visible card; ``devices=`` names the list
(a device may repeat: ``["cpu"] * 8`` stands for XLA's 8 virtual host
devices, ``["cuda:0", "cuda:0"]`` drives the split on one card).  The
batch is rounded up to a multiple of the device count, the model is
replicated once per distinct device, and the engine's one process places
the shards itself: each dispatch zero-pads to the static batch, splits it
into equal shards and runs one on each device;
batch entries are independent through every conv, so the split changes
no pixel.  With one device nothing is padded: every batch runs at its
own size.

Transfers (on CUDA): the planes are copied into one pinned host buffer
each and every shard's rows are uploaded from it with ``non_blocking``
under its device, on the compute stream.  Each distinct device has a
download stream of its own: at dispatch it waits on the shard's compute
event and copies the shard's output into its rows of one pinned output
buffer per plane, then records a copy event.  The next batch's kernels
thus run on the compute stream while this batch's output crosses PCIe on
the card's other copy engine.  Every tensor either stream touches is
held by the batch's handle until :meth:`_fetch` has synchronised both
events, and each output the download stream reads is recorded on it, so
no block is handed out again while a stream may still use it; PyTorch's
caching host allocator hands a freed pinned block out again only after
the copies recorded on it have completed.

Output (:meth:`upscale_to`): each frame's planes go to the sink as 1-D
byte views of the pinned output's rows, with no host copy.  A view holds
its pinned buffer alive, and the engine takes a fresh buffer for every
batch, so a sink may keep what it is given: no later batch writes into
it (it holds pinned host memory while it does).

Hops (``parallel/transfer.py``): the thread that runs :meth:`upscale_to`
bills each batch's ``read`` (the source's frames, parsed and stacked),
``h2d``, ``launch`` (on CUDA: the model's launches on every shard, the
output buffers, the d2h enqueue and the events), ``compute`` (the wait on
the card; on the CPU, the synchronous model step), ``d2h`` (the wait on
the download streams) and ``write`` (the sink's own writes of the views)
into :attr:`FrameUpscaler.hop_sink`, and, while a sink is bound,
``device``: the card's seconds for the batch, the longest shard's, from
timing events around its compute.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from typing import (Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from .. import resolve_device
from .checkpoint import restore_state
from .models.upscaler import Upscaler, UpscalerConfig
from .ops.colorspace import (
    downsample_chroma,
    fused_subpixel_ycc,
    fused_subpixel_ycc_s2d,
    rgb_to_ycbcr,
    upsample_chroma,
    ycbcr_to_unit_rgb,
)
from .ops.pixel_shuffle import quantize_u8
from .ops.s2d_head import s2d_head
from .parallel.transfer import HopSink, TransferQueue, timed_hop, timed_next
from .video import Y4MError, Y4MHeader, Y4MReader, Y4MWriter

# -- spatial tiling, as the reference decides it ------------------------
#
# The constants are the reference's, kept unchanged: they were measured
# on a 16 GB TPU, and re-deriving them for an 80 GB H100 is later,
# measured work.

TARGET_FRAMES = 8
TILE_MIN_PX = 1920 * 1080


def _tile_halo(depth: int) -> int:
    """Receptive radius (depth+2) rounded up to even, +2 margin."""
    r = depth + 4
    return r + (r % 2)


def _tile_grid(height: int, width: int, sub_h: int, sub_w: int,
               halo: int, batch: int = TARGET_FRAMES) -> Tuple[int, int]:
    """(rows, cols) split restoring >= TARGET_FRAMES per dispatch when
    ``batch`` frames alone are too few; (1, 1) = no tiling."""
    if batch >= TARGET_FRAMES or height * width <= TILE_MIN_PX:
        return (1, 1)
    want = -(-TARGET_FRAMES // max(1, batch))  # tiles per frame needed
    best = None
    for sh in (1, 2, 4):
        for sw in (1, 2, 4):
            if sh * sw < want:
                continue
            kh, kw = height // sh, width // sw
            if height % (sh * max(2, sub_h)) or width % (sw * max(2, sub_w)):
                continue
            if kh <= 2 * halo or kw <= 2 * halo:
                continue
            tile_h = kh + (2 * halo if sh > 1 else 0)
            tile_w = kw + (2 * halo if sw > 1 else 0)
            key = (tile_h, tile_w)
            if best is None or key < best[0]:
                best = (key, (sh, sw))
    return best[1] if best else (1, 1)


def _tile_anchors(dim: int, splits: int, halo: int) -> "list[tuple[int, int]]":
    """Per-tile (anchor, crop_offset): input slice [anchor, anchor+T)
    with T = dim/splits + 2*halo, kept output [i*K, (i+1)*K) at
    crop_offset inside the tile.  Clamping puts outer tile edges on the
    frame edges (exact SAME-padding semantics there)."""
    if splits == 1:
        return [(0, 0)]
    kept = dim // splits
    tile = kept + 2 * halo
    out = []
    for i in range(splits):
        anchor = min(max(i * kept - halo, 0), dim - tile)
        out.append((anchor, i * kept - anchor))
    return out


# no_tf32's process-wide state: how many calls are inside it, and the
# flags the first of them found
_TF32_LOCK = threading.Lock()
_tf32_users = 0
_tf32_saved: Tuple[bool, bool] = (False, False)


@contextlib.contextmanager
def no_tf32():
    """Run cuDNN's convs and cuBLAS's matmuls in true f32 (the f32-compute
    configuration must not drop to TF32; bf16 compute is unaffected),
    then restore the process-wide flags for any other torch code.

    Safe across threads (concurrent stage jobs share one engine): TF32
    stays off while any call is inside, and the last one to leave puts
    back the flags the first one found."""
    global _tf32_users, _tf32_saved
    with _TF32_LOCK:
        if _tf32_users == 0:
            _tf32_saved = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_users += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _tf32_users -= 1
            if _tf32_users == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _tf32_saved


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the card it means (``cuda:<current>``), so devices
    compare equal to a tensor's ``.device``."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass
class _InFlight:
    """One dispatched batch: its host-side outputs (pinned and filling on
    CUDA, each shard's rows copied into place), per shard the events that
    mark its compute and copy done, every buffer the devices may still
    read or write, and how many of the rows are frames (the rest is
    padding)."""

    outputs: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    computed: List[torch.cuda.Event]
    copied: List[torch.cuda.Event]
    keep: List[torch.Tensor]
    n: int
    # per shard, the timing event before its compute (only while a hop
    # sink is bound; ``computed`` is then timing-enabled too)
    started: List[torch.cuda.Event] = dataclasses.field(default_factory=list)


class FrameUpscaler:
    """Holds the model and runs every inference branch, data-parallel
    over its devices."""

    # Pixel budget per dispatch, kept from the reference unchanged: sized
    # there for a 16 GB TPU (8 x 1080p).  Re-deriving it for an 80 GB
    # H100 is later, measured work.
    PIXEL_BUDGET = 8 * 1920 * 1080

    def __init__(
        self,
        config: UpscalerConfig = UpscalerConfig(),
        batch: int = 8,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        seed: int = 0,
        device=None,
        checkpoint_dir: Optional[str] = None,
        use_mesh: bool = True,
        devices: Optional[Sequence] = None,
    ):
        """``params`` is a state dict of :class:`Upscaler` (e.g. from
        :func:`..weights.from_flax`); ``checkpoint_dir`` a directory the
        trainer of either package saved to, whose latest step's params
        are loaded (its
        optimizer state is ignored; a missing, foreign or mismatched
        checkpoint raises, as :func:`..checkpoint.restore_state` does).
        Without either the model is seeded from ``seed``.  ``device``
        defaults to CUDA and raises without a GPU; pass ``"cpu"`` for the
        plain PyTorch path.  ``use_mesh`` spreads the batch over every
        visible card (on the CPU there is one device); ``devices`` names
        the devices instead, repeats allowed."""
        if params is not None and checkpoint_dir is not None:
            raise ValueError("pass params or checkpoint_dir, not both")
        if devices is not None:
            devices = [_indexed(resolve_device(d)) for d in devices]
            if not devices:
                raise ValueError("devices= names no device")
        else:
            home = _indexed(resolve_device(device))
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if use_mesh and home.type == "cuda" else [home])
        self.devices: List[torch.device] = devices
        self.device = devices[0]
        self.config = config
        model = Upscaler(config, seed=seed)
        if checkpoint_dir is not None:
            _step, params, _opt = restore_state(checkpoint_dir, model.state_dict())
        if params is not None:
            model.load_state_dict(params)
        model.eval().requires_grad_(False)
        # one replica per distinct device, each a copy of the same weights
        distinct = list(dict.fromkeys(devices))
        self._replicas = {dev: copy.deepcopy(model).to(dev)
                          for dev in distinct[1:]}
        self._replicas[self.device] = model.to(self.device)
        # one download stream per distinct card: the d2h copies leave the
        # compute stream, so the next batch's kernels overlap them
        self._download = {dev: torch.cuda.Stream(dev)
                          for dev in distinct if dev.type == "cuda"}
        self.model = self._replicas[self.device]
        self.n_devices = len(devices)
        # static batch: a multiple of the device count, so every device
        # gets an equal shard
        self.batch = -(-max(1, batch) // self.n_devices) * self.n_devices
        # per-job hop billing target (see parallel/transfer.py)
        self.hop_sink = HopSink("engine")

    def batch_for(self, height: int, width: int) -> int:
        """Resolution-aware dispatch size: the configured batch, capped
        so per-device pixels stay inside :data:`PIXEL_BUDGET`."""
        per_device = max(1, self.PIXEL_BUDGET // (height * width))
        return min(self.batch, per_device * self.n_devices)

    def tile_grid(self, height: int, width: int, sub_h: int,
                  sub_w: int) -> Tuple[int, int]:
        """The (rows, cols) tile grid a dispatch of (height, width) frames
        runs at; (1, 1) = untiled.  Decided, as the reference does, on
        the per-device dispatch batch :meth:`batch_for` gives."""
        return _tile_grid(height, width, sub_h, sub_w,
                          _tile_halo(self.config.depth),
                          batch=self.batch_for(height, width) // self.n_devices)

    def _unit_rgb(self, y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                  sub_h: int, sub_w: int) -> torch.Tensor:
        return ycbcr_to_unit_rgb(y.float(),
                                 upsample_chroma(cb.float(), sub_h, sub_w),
                                 upsample_chroma(cr.float(), sub_h, sub_w))

    def _model_on(self, device: torch.device) -> Upscaler:
        """The replica on ``device``."""
        return self._replicas[device]

    def _s2d_head(self, rgb: torch.Tensor) -> torch.Tensor:
        model = self._model_on(rgb.device)
        head = model.subpixel
        with no_tf32():
            feats = model.trunk(rgb)
            return s2d_head(feats, head.weight.permute(2, 3, 1, 0), head.bias,
                            self.config.compute_dtype)

    @torch.inference_mode()
    def packed_head(self, y: torch.Tensor, cb: torch.Tensor,
                    cr: torch.Tensor) -> torch.Tensor:
        """Main-path (n, H, W)/(n, H/scale, W/scale) u8 planes on the
        engine's device -> the s2d head's packed (n, H/2, W/2,
        4*scale^2*3) output."""
        scale = self.config.scale
        return self._s2d_head(self._unit_rgb(y, cb, cr, scale, scale))

    def _branch(self, y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                sub_h: int, sub_w: int) -> Tuple[torch.Tensor, ...]:
        """The reference's ``core``: one of the three branches on whole
        (or tiled) frames."""
        scale = self.config.scale
        rgb = self._unit_rgb(y, cb, cr, sub_h, sub_w)
        if (sub_h, sub_w) == (scale, scale):
            if y.shape[1] % 2 == 0 and y.shape[2] % 2 == 0:
                return fused_subpixel_ycc_s2d(self._s2d_head(rgb), scale)
            # odd frame dims: the fused sub-pixel tail on the plain head
            with no_tf32():
                h12 = self._model_on(rgb.device).backbone(rgb)
            return fused_subpixel_ycc(h12, scale)
        # generic tail: shuffle, then transform
        with no_tf32():
            out = self._model_on(rgb.device)(rgb)
        y2, cb2, cr2 = rgb_to_ycbcr(out.float() * 255.0)
        cb2 = downsample_chroma(cb2, sub_h, sub_w)
        cr2 = downsample_chroma(cr2, sub_h, sub_w)
        return tuple(quantize_u8(p.contiguous()) for p in (y2, cb2, cr2))

    def _tiled(self, y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
               sub_h: int, sub_w: int, rows: int,
               cols: int) -> Tuple[torch.Tensor, ...]:
        """Cut halo'd tiles, fold them into the batch dim (tile-major),
        run :meth:`_branch` once, crop the halos and stitch."""
        height, width = y.shape[1], y.shape[2]
        halo = _tile_halo(self.config.depth)
        scale = self.config.scale
        h_anchors = _tile_anchors(height, rows, halo)
        w_anchors = _tile_anchors(width, cols, halo)
        kept_h, kept_w = height // rows, width // cols
        tile_h = kept_h + (2 * halo if rows > 1 else 0)
        tile_w = kept_w + (2 * halo if cols > 1 else 0)
        corners = [(ah, aw) for ah, _ in h_anchors for aw, _ in w_anchors]

        def cut(plane, dh, dw):
            return torch.cat([plane[:, ah // dh:(ah + tile_h) // dh,
                                    aw // dw:(aw + tile_w) // dw]
                              for ah, aw in corners])

        outs = self._branch(cut(y, 1, 1), cut(cb, sub_h, sub_w),
                            cut(cr, sub_h, sub_w), sub_h, sub_w)
        n = y.shape[0]
        stitched = []
        for plane, (dh, dw) in zip(outs, ((1, 1), (sub_h, sub_w), (sub_h, sub_w))):
            tiles = plane.split(n)
            th, tw = kept_h * scale // dh, kept_w * scale // dw
            out_rows = []
            for r, (_, oh) in enumerate(h_anchors):
                y0 = oh * scale // dh
                out_rows.append(torch.cat([
                    tiles[r * cols + c][:, y0:y0 + th,
                                        ow * scale // dw:ow * scale // dw + tw]
                    for c, (_, ow) in enumerate(w_anchors)], dim=2))
            stitched.append(torch.cat(out_rows, dim=1))
        return tuple(stitched)

    @torch.inference_mode()
    def _core(self, y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
              sub_h: int, sub_w: int) -> Tuple[torch.Tensor, ...]:
        """(n, H, W)/(n, H/sub_h, W/sub_w) u8 device planes -> upscaled
        u8 planes, tiled where :meth:`tile_grid` says so."""
        rows, cols = self.tile_grid(y.shape[1], y.shape[2], sub_h, sub_w)
        if rows * cols == 1:
            return self._branch(y, cb, cr, sub_h, sub_w)
        return self._tiled(y, cb, cr, sub_h, sub_w, rows, cols)

    # ------------------------------------------------------------------
    def _dispatch(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                  sub_h: int, sub_w: int) -> _InFlight:
        """Stage and launch one batch WITHOUT waiting for the devices: on
        several devices zero-padded to the static batch and cut into one
        equal shard per device, each shard's d2h copy queued on its
        device's download stream behind its compute, into its rows of
        one pinned output.  :meth:`_fetch` materializes the result."""
        planes = (y, cb, cr)
        n = y.shape[0]
        total = n
        if self.n_devices > 1:
            total = max(n, self.batch_for(y.shape[1], y.shape[2]))
        rows = total // self.n_devices
        nbytes = int(sum(a[0].nbytes for a in planes)) * total
        if self.device.type == "cpu":
            # the same three hops as on the card, around the steps that
            # stand for them here: wrapping, the (synchronous) compute,
            # and the conversion back in _fetch
            with timed_hop(self.hop_sink, "h2d", nbytes):
                dev = [torch.from_numpy(np.ascontiguousarray(a)) for a in planes]
                if total > n:
                    dev = [torch.cat([t, t.new_zeros((total - n, *t.shape[1:]))])
                           for t in dev]
            with timed_hop(self.hop_sink, "compute") as billed:
                shards = [self._core(*(t[i * rows:(i + 1) * rows] for t in dev),
                                     sub_h, sub_w) for i in range(self.n_devices)]
                out = tuple(torch.cat(parts) if len(parts) > 1 else parts[0]
                            for parts in zip(*shards))
                billed.nbytes = sum(int(t.numel()) for t in out)
            return _InFlight(out, [], [], [], n)
        with timed_hop(self.hop_sink, "h2d", nbytes):
            pinned = []
            for arr in planes:
                buf = torch.empty((total, *arr.shape[1:]), dtype=torch.uint8,
                                  pin_memory=True)
                view = buf.numpy()
                view[:n] = arr
                view[n:] = 0
                pinned.append(buf)
            dev = []
            for i, device in enumerate(self.devices):
                with torch.cuda.device(device):
                    dev.append([buf[i * rows:(i + 1) * rows].to(device, non_blocking=True)
                                for buf in pinned])
        timed = self.hop_sink.is_bound()
        handle = _InFlight(None, [], [], pinned, n)
        with timed_hop(self.hop_sink, "launch", nbytes):
            for i, (device, planes_i) in enumerate(zip(self.devices, dev)):
                with torch.cuda.device(device):
                    if timed:
                        started = torch.cuda.Event(enable_timing=True)
                        started.record()
                        handle.started.append(started)
                    out = self._core(*planes_i, sub_h, sub_w)
                    computed = torch.cuda.Event(enable_timing=timed)
                    computed.record()
                    if handle.outputs is None:
                        handle.outputs = tuple(
                            torch.empty((total, *t.shape[1:]), dtype=torch.uint8,
                                        pin_memory=True) for t in out)
                    download = self._download[device]
                    download.wait_event(computed)
                    with torch.cuda.stream(download):
                        for dst, src in zip(handle.outputs, out):
                            dst[i * rows:(i + 1) * rows].copy_(src, non_blocking=True)
                            # freed on the compute stream, read here
                            src.record_stream(download)
                        copied = torch.cuda.Event()
                        copied.record()
                handle.computed.append(computed)
                handle.copied.append(copied)
                handle.keep.extend([*planes_i, *out])
        return handle

    def _fetch(self, handle: _InFlight) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Materialize one dispatched batch, billing ``compute`` as the
        wait for every shard's compute event, ``device`` as the longest
        shard's compute on its card (timed while a sink was bound at
        dispatch) and ``d2h`` as the wait for the download streams'
        copies (mostly done by then: they ran beside the next batch's
        compute); on the CPU ``d2h`` is the conversion to numpy.  The
        padding is dropped."""
        nbytes = sum(int(t.numel()) for t in handle.outputs)
        if handle.computed:  # on the CPU compute was billed at dispatch
            with timed_hop(self.hop_sink, "compute", nbytes):
                for event in handle.computed:
                    event.synchronize()
            if handle.started:
                self.hop_sink.note("device", nbytes, max(
                    start.elapsed_time(end)
                    for start, end in zip(handle.started, handle.computed)) / 1e3)
        with timed_hop(self.hop_sink, "d2h", nbytes):
            for event in handle.copied:
                event.synchronize()
            handle.keep.clear()
            y2, cb2, cr2 = (t.numpy()[:handle.n] for t in handle.outputs)
        return y2, cb2, cr2

    def upscale_batch(
        self,
        y: np.ndarray,
        cb: np.ndarray,
        cr: np.ndarray,
        sub_h: int,
        sub_w: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Upscale (n, H, W)/(n, ch, cw) uint8 planes, any n; n beyond
        :meth:`batch_for` is pipelined through capped chunks."""
        eff = self.batch_for(y.shape[1], y.shape[2])
        if y.shape[0] <= eff:
            return self._fetch(self._dispatch(y, cb, cr, sub_h, sub_w))
        queue = TransferQueue(self._dispatch, self._fetch, depth=3)
        parts = []
        for i in range(0, y.shape[0], eff):
            parts.extend(queue.submit(
                y[i:i + eff], cb[i:i + eff], cr[i:i + eff], sub_h, sub_w))
        parts.extend(queue.drain())
        return tuple(
            np.concatenate([part[plane] for part in parts])
            for plane in range(3)
        )

    def upscale_y4m(self, src_path: str, dst_path: str) -> int:
        """Upscale a Y4M file; returns the number of frames written."""
        with open(src_path, "rb") as src:
            return self.upscale_stream(src, dst_path)

    def upscale_stream(self, src_fh, dst_path: str, depth: int = 3) -> int:
        """Upscale a Y4M byte stream (file or pipe) to ``dst_path``;
        returns the number of frames written."""
        with open(dst_path, "wb") as dst:
            return self.upscale_to(src_fh, dst, depth=depth)

    def upscale_to(self, src_fh, dst_fh, depth: int = 3) -> int:
        """Upscale a Y4M byte stream into an open writable (a file, or an
        encoder's stdin); returns the number of frames written.

        Keeps up to ``depth`` batches in flight through a
        :class:`TransferQueue`: batch i+1 is read, staged and dispatched
        while batch i still computes and batch i-1's d2h drains."""
        reader = Y4MReader(src_fh)
        hdr = reader.header
        out_hdr = Y4MWriter(dst_fh, hdr.scaled(self.config.scale)).header
        sub_h, sub_w = hdr.subsampling
        frames = 0

        def write_out(result) -> None:
            nonlocal frames
            y2, cb2, cr2 = result
            with timed_hop(self.hop_sink, "write",
                           y2.nbytes + cb2.nbytes + cr2.nbytes):
                for i in range(y2.shape[0]):
                    _write_frame(dst_fh, out_hdr, y2[i], cb2[i], cr2[i])
            frames += y2.shape[0]

        queue = TransferQueue(self._dispatch, self._fetch,
                              depth=max(1, depth))
        batches = _batched(iter(reader), self.batch_for(hdr.height, hdr.width))
        while (planes := timed_next(self.hop_sink, "read", batches)) is not None:
            for result in queue.submit(*planes, sub_h, sub_w):
                write_out(result)
        for result in queue.drain():
            write_out(result)
        return frames


def _write_frame(fh, hdr: Y4MHeader, y: np.ndarray, cb: np.ndarray,
                 cr: np.ndarray) -> None:
    """``Y4MWriter.write_frame``'s check and record, with each plane
    handed to ``fh`` as a 1-D byte view of its rows instead of a copy."""
    if (
        y.shape != (hdr.height, hdr.width)
        or cb.shape != hdr.chroma_shape
        or cr.shape != hdr.chroma_shape
    ):
        raise Y4MError(
            f"frame planes {y.shape}/{cb.shape}/{cr.shape} do not match "
            f"header {hdr.width}x{hdr.height} C{hdr.colorspace}"
        )
    fh.write(b"FRAME\n")
    for plane in (y, cb, cr):
        fh.write(memoryview(np.ascontiguousarray(plane, dtype=np.uint8)).cast("B"))


def _batched(
    frames: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]], batch: int
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    ys, cbs, crs = [], [], []
    for y, cb, cr in frames:
        ys.append(y)
        cbs.append(cb)
        crs.append(cr)
        if len(ys) == batch:
            yield np.stack(ys), np.stack(cbs), np.stack(crs)
            ys, cbs, crs = [], [], []
    if ys:
        yield np.stack(ys), np.stack(cbs), np.stack(crs)


def upscaler_flops_per_frame(config: UpscalerConfig, height: int, width: int) -> int:
    """Matmul-equivalent FLOPs of one plain forward pass on one (H, W)
    frame: conv MACs x2; elementwise work and the colorspace math are
    excluded.  (The s2d head does 16/9 of the plain head's MACs.)"""
    f = config.features
    pixels = height * width
    stem = 2 * pixels * 5 * 5 * config.channels * f
    body = (config.depth - 1) * 2 * pixels * 3 * 3 * f * f
    head = 2 * pixels * 3 * 3 * f * (config.channels * config.scale**2)
    return stem + body + head
