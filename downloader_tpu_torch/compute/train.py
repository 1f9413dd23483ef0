"""Training step for the upscaler — the port of
``downloader_tpu/compute/train.py:22-50``.

One step: forward in the compute dtype (bf16 by default) -> an f32 MSE
-> backward -> Adam.  The forward runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
counterpart of ``jax.checkpoint``: its activations are recomputed in the
backward instead of held.  (The reentrant variant returns no parameter
gradients when the segment's input needs none, and says nothing.)

JAX's step is a pure function that returns a new state; here the state
is a :class:`TrainState` (the model and its optimizer) that a step
updates in place, and the step returns the loss as a device tensor so
nothing waits for the card until the caller reads it.

The convs and their backward run on cuDNN, as the reference leaves them
to XLA; Adam is ``torch.optim.Adam`` with optax's defaults (betas 0.9 /
0.999, eps 1e-8), fused on the card.  TF32 stays off around the step, as
in the engine, so the f32-compute configuration computes in f32.

:func:`compile_train_step` picks the step for where it runs (the
reference's ``train.py:53-75``).  Without a process group it is the step
above, on one device.  In a process group of one rank per card (NCCL on
cards, gloo on the CPU) it is the (data x model) step: each rank holds
its rows of the batch and, per
:data:`~.parallel.partition.UPSCALER_RULES`, the output channels of
every trunk conv that its ``model`` coordinate owns; each trunk conv's
slice is all-gathered over the ``model`` group on the channel dim before
the relu and the residual add (the sub-pixel head is replicated), and
the gradients and the loss are averaged over the ``data`` group, so Adam
updates each rank's shards and every rank reads the same loss.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from .models.upscaler import Upscaler, UpscalerConfig
from .parallel.mesh import MeshPlan, shard_params
from .pipeline import no_tf32


@dataclasses.dataclass
class TrainState:
    """The port's ``(params, opt_state)``: the model holds the params,
    the optimizer their Adam moments and step count; ``plan`` is the
    mesh the params are sharded on (None on one device)."""

    model: Upscaler
    optimizer: torch.optim.Optimizer
    plan: Optional[MeshPlan] = None


def make_optimizer(model: Upscaler, learning_rate: float = 1e-3
                   ) -> torch.optim.Adam:
    """``optax.adam(learning_rate)``'s update as ``torch.optim.Adam``:
    the fused implementation for parameters on the card, the default one
    on the CPU."""
    on_card = next(model.parameters()).device.type == "cuda"
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            fused=True if on_card else None)


def make_train_step(config: UpscalerConfig = UpscalerConfig(),
                    learning_rate: float = 1e-3, device=None
                    ) -> Tuple[Callable[..., torch.Tensor], Callable[..., TrainState]]:
    """Returns ``(train_step, init_state)`` for ``loss = MSE(model(lr), hr)``.

    ``init_state(seed=0)`` builds a :class:`TrainState` on the device,
    its weights drawn from a ``torch.Generator`` seeded with ``seed``
    (flax's distributions, not flax's numbers).  ``train_step(state,
    low_res, high_res)`` takes (B, h, w, 3) and (B, h*scale, w*scale, 3)
    tensors on that device, updates ``state`` in place and returns the
    step's loss (computed before the update) as a 0-d f32 device tensor.
    ``device`` defaults to CUDA and raises without a GPU."""
    dev = resolve_device(device)

    def train_step(state: TrainState, low_res: torch.Tensor,
                   high_res: torch.Tensor) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        with no_tf32():
            pred = checkpoint(state.model, low_res, use_reentrant=False,
                              preserve_rng_state=False)
            # f32 reduction whatever the compute dtype
            err = pred.float() - high_res.float()
            loss = torch.mean(err * err)
            loss.backward()
        state.optimizer.step()
        return loss.detach()

    def init_state(seed: int = 0) -> TrainState:
        model = Upscaler(config, seed=seed).to(dev)
        return TrainState(model, make_optimizer(model, learning_rate))

    return train_step, init_state


class _GatherChannels(torch.autograd.Function):
    """All-gather an NCHW (channels_last) activation's channel slices over
    the ``model`` group.  What follows the gather is replicated over the
    group, so every rank holds the same gradient of the whole; the
    backward keeps this rank's slice of it, with no collective."""

    @staticmethod
    def forward(ctx, x, group, parts: int, index: int):
        import torch.distributed as dist

        nhwc = x.permute(0, 2, 3, 1).contiguous()
        blocks = [torch.empty_like(nhwc) for _ in range(parts)]
        dist.all_gather(blocks, nhwc, group=group)
        ctx.index, ctx.width = index, nhwc.shape[-1]
        return torch.cat(blocks, dim=-1).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.index * ctx.width
        return grad[:, start:start + ctx.width], None, None, None


class _SumGradOverGroup(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the ``model``
    group: each rank's conv slice gives only its share of the input's
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class ShardedUpscaler(Upscaler):
    """The upscaler on one rank of a (data x model) plan in a process
    group: its trunk convs hold this rank's output channels (``stem`` and
    ``body_{i}`` weights ``(features / T, cin, k, k)``, biases
    ``(features / T,)``), ``subpixel`` is whole.  Every rank draws the
    whole model from ``seed`` and keeps its block
    (:func:`~.parallel.mesh.shard_params`), the reference's recipe."""

    def __init__(self, config: UpscalerConfig, plan: MeshPlan, seed: int = 0):
        super().__init__(config, seed=seed)
        if config.features % plan.shape["model"]:
            raise ValueError(f"features {config.features} not divisible by "
                             f"model axis {plan.shape['model']}")
        self.plan = plan
        for name, t in shard_params(plan, self.state_dict()).items():
            module, leaf = name.rsplit(".", 1)
            setattr(getattr(self, module), leaf, nn.Parameter(t))

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherChannels.apply(x, self.plan.group("model"),
                                     self.plan.shape["model"], self.plan.coords[1])

    def _trunk_nchw(self, frames: torch.Tensor) -> torch.Tensor:
        dt = self.config.compute_dtype
        group = self.plan.group("model")
        x = frames.to(dt).permute(0, 3, 1, 2)
        x = F.relu(self._gather(self.stem(x, dt)))
        for conv in self.convs()[1:-1]:
            part = conv(_SumGradOverGroup.apply(x, group), dt)
            x = F.relu(self._gather(part)) + x
        return x


def _sharded_train_step(config: UpscalerConfig, plan: MeshPlan,
                        learning_rate: float):
    """``(train_step, init_state)`` of one rank of ``plan``'s group."""
    import torch.distributed as dist

    data = plan.shape["data"]

    def train_step(state: TrainState, low_res: torch.Tensor,
                   high_res: torch.Tensor) -> torch.Tensor:
        state.optimizer.zero_grad(set_to_none=True)
        with no_tf32():
            pred = checkpoint(state.model, low_res, use_reentrant=False,
                              preserve_rng_state=False)
            err = pred.float() - high_res.float()
            loss = torch.mean(err * err)
            loss.backward()
        # one collective: this rank's loss and gradients, averaged over
        # the data group (the local batches are equal, so the mean of
        # the local means is the global mean)
        params = list(state.model.parameters())
        flat = torch.cat([loss.detach().reshape(1)]
                         + [p.grad.reshape(-1) for p in params])
        dist.all_reduce(flat, group=plan.group("data"))
        flat /= data
        offset = 1
        for p in params:
            p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
            offset += p.numel()
        state.optimizer.step()
        return flat[0]

    def init_state(seed: int = 0) -> TrainState:
        model = ShardedUpscaler(config, plan, seed=seed)
        return TrainState(model, make_optimizer(model, learning_rate), plan)

    return train_step, init_state


def compile_train_step(config: UpscalerConfig = UpscalerConfig(),
                       mesh: Optional[MeshPlan] = None,
                       learning_rate: float = 1e-3, device=None
                       ) -> Tuple[Callable[..., torch.Tensor],
                                  Callable[..., TrainState], Optional[MeshPlan]]:
    """The train step for ``mesh``; returns ``(step, init_state, plan)``,
    ``plan`` being the plan the step runs on (``mesh``, or None).

    Without ``mesh`` (or on a plan of one process) it is
    :func:`make_train_step`'s step on ``device`` (the plan's).  On a plan
    in a process group it is the (data x model) step of this rank
    (module docstring): ``init_state(seed)`` shards a seeded init onto
    the plan, and ``step(state, low_res, high_res)`` takes this rank's
    rows (:func:`~.parallel.mesh.shard_batch`) and returns the loss of
    the whole batch.  A plan of one process over several devices raises:
    training is one process per device."""
    if mesh is not None and mesh.mesh is not None:
        if device is not None and resolve_device(device).type != mesh.device.type:
            raise ValueError(f"device {device} is not the plan's {mesh.device}")
        train_step, init_state = _sharded_train_step(config, mesh, learning_rate)
    else:
        if mesh is not None:
            if mesh.size > 1:
                raise ValueError(
                    f"a plan of one process over {mesh.size} devices cannot "
                    "train: run one process per device in a process group "
                    "(parallel.group.run_group, or torchrun)")
            device = mesh.device
        train_step, init_state = make_train_step(config, learning_rate, device)
    return train_step, init_state, mesh
