"""The training step on one device.

Counterpart of ``clipcap_tpu/train/step.py::train_step``: the loss, its
gradients, the optional clip and the AdamW update.  The JAX step is a pure
jitted function over a donated state; here the parameters and moments are
updated in place and the step count is a host int.  There is no mesh: data
parallelism and ZeRO-1 wait for ROADMAP.md A9.
"""
from __future__ import annotations

import torch

from clipcap_tpu_torch.models.clipcap import clipcap_loss
from clipcap_tpu_torch.train.state import AdamW, TrainState

Tensor = torch.Tensor


def train_step(state: TrainState, tokens: Tensor, embeddings: Tensor, *, tx: AdamW,
               dtype=torch.bfloat16, remat: bool = False) -> Tensor:
    """One step on ``tokens`` [B, T] (-1 pads) and ``embeddings`` [B, E] or
    [B, W, E], on the model's device.  Returns the loss (a device scalar:
    reading it syncs)."""
    named = dict(state.model.named_parameters())
    params = [named[name] for name in state.opt_state.mu]     # the moments' order
    loss = clipcap_loss(state.model, tokens, embeddings, dtype=dtype, remat=remat)
    grads = torch.autograd.grad(loss, params)
    tx.update_(params, grads, state.opt_state)
    state.step += 1
    return loss.detach()
