"""Training step for the upscaler — the port of
``downloader_tpu/compute/train.py:22-50``.

One step: forward in the compute dtype (bf16 by default) -> an f32 MSE
-> backward -> Adam.  The forward runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, the
counterpart of ``jax.checkpoint``: its activations are recomputed in the
backward instead of held.  (The reentrant variant returns no parameter
gradients when the segment's input needs none, and says nothing.)

JAX's step is a pure function whose donated state comes back new; here
the state is a :class:`TrainState` (the model and its optimizer) that a
step updates in place, and the step returns the loss as a device tensor
so nothing waits for the card until the caller reads it.

The convs and their backward run on cuDNN, as the reference leaves them
to XLA; Adam is ``torch.optim.Adam`` with optax's defaults (betas 0.9 /
0.999, eps 1e-8), fused on the card.  TF32 stays off around the step, as
in the engine, so the f32-compute configuration computes in f32.

``compile_train_step`` (the mesh, the pjit/shard_map chooser, buffer
donation) belongs to the multi-GPU slice and is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from .models.upscaler import Upscaler, UpscalerConfig
from .pipeline import no_tf32


@dataclasses.dataclass
class TrainState:
    """The port's ``(params, opt_state)``: the model holds the params,
    the optimizer their Adam moments and step count."""

    model: Upscaler
    optimizer: torch.optim.Optimizer


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
