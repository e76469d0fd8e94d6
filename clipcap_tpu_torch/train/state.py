"""Train state and optimizer: the JAX package's ``train/state.py`` (optax
AdamW with a linear warmup/decay schedule, prefix-only masking, optional
global-norm clipping) in PyTorch.

The step and the optimizer's count live on the host, so the schedule and
the bias corrections are host floats and a step needs no device sync.
Parameters stay fp32 in the model's modules and are updated in place; the
moments are fp32 tensors of the same shapes, one per trained parameter.
Prefix-only training trains the mapper alone: GPT-2's parameters take no
gradients and get no moments, as under the JAX package's
``optax.multi_transform`` with ``set_to_zero``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clipcap_tpu_torch.models.clipcap import ClipCapModel
from clipcap_tpu_torch.ops.fused_adamw import adamw_, adamw_scalars, fused_adamw

Tensor = torch.Tensor

B1, B2, EPS = 0.9, 0.999, 1e-8     # optax.adamw's defaults, which the JAX package uses


def linear_warmup_decay(lr: float, warmup_steps: int, total_steps: int):
    """HF ``get_linear_schedule_with_warmup`` with the JAX package's clamps,
    in float32 and in its order: ``lr·step/warm`` below ``warm``, then
    ``lr·max(0, (total-step)/max(1, total-warm))``, with ``warm >= 1`` and
    ``total >= warm + 1``."""
    f = np.float32
    warm = max(f(1.0), f(warmup_steps))
    total = max(warm + f(1.0), f(total_steps))

    def schedule(step: int) -> float:
        s = f(step)
        if s < warm:
            frac = s / warm
        else:
            frac = max(f(0.0), (total - s) / max(f(1.0), total - warm))
        return float(f(lr) * frac)

    return schedule


def clip_by_global_norm_(grads: Sequence[Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm``, in place: when the global norm
    ``‖g‖ >= max_norm``, every grad becomes ``g / ‖g‖ · max_norm`` (no
    epsilon).  The choice is made on the device: no sync."""
    norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


@dataclasses.dataclass
class AdamWState:
    """The moments of the trained parameters (by name in ``ClipCapModel``,
    fp32, the parameters' shapes) and the 0-based count of updates."""

    count: int
    mu: Dict[str, Tensor]
    nu: Dict[str, Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW at ``linear_warmup_decay(lr, …)`` with decoupled weight decay,
    after an optional clip; ``fused`` takes the one-pass CUDA kernel
    (``ops.fused_adamw``), else separate tensor ops in optax's order."""

    lr: float
    warmup_steps: int
    total_steps: int
    train_language_model: bool = False
    weight_decay: float = 0.01
    grad_clip_norm: Optional[float] = None
    fused: bool = False

    @property
    def schedule(self):
        return linear_warmup_decay(self.lr, self.warmup_steps, self.total_steps)

    def trained(self, model: ClipCapModel) -> List[Tuple[str, torch.nn.Parameter]]:
        """The parameters this optimizer updates, in module order."""
        return [(name, p) for name, p in model.named_parameters()
                if self.train_language_model or name.startswith("transformer_mapper.")]

    def init(self, model: ClipCapModel) -> AdamWState:
        names = [name for name, _ in self.trained(model)]
        params = dict(model.named_parameters())
        zeros = lambda: {n: torch.zeros_like(params[n], dtype=torch.float32) for n in names}
        return AdamWState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update_(self, params: Sequence[Tensor], grads: Sequence[Tensor],
                state: AdamWState) -> None:
        """One step: clip, then AdamW on ``params`` in place; ``params``
        and ``grads`` come in the order of ``state.mu``.  The schedule
        reads the 0-based count, the bias corrections the 1-based one, as
        in optax."""
        if self.grad_clip_norm:
            clip_by_global_norm_(grads, self.grad_clip_norm)
        lr = self.schedule(state.count)
        state.count += 1
        scalars = adamw_scalars(lr, B1, B2, EPS, self.weight_decay, state.count)
        mu, nu = list(state.mu.values()), list(state.nu.values())
        if self.fused:
            fused_adamw(params, grads, mu, nu, scalars)
        else:
            # optax takes 1 - b in double, rounded once to float32.
            adamw_(params, grads, mu, nu, scalars,
                   float(np.float32(1 - B1)), float(np.float32(1 - B2)))


def make_optimizer(lr: float, warmup_steps: int, total_steps: int,
                   train_language_model: bool = False, weight_decay: float = 0.01,
                   grad_clip_norm: Optional[float] = None, fused: bool = False) -> AdamW:
    return AdamW(lr=lr, warmup_steps=warmup_steps, total_steps=total_steps,
                 train_language_model=train_language_model, weight_decay=weight_decay,
                 grad_clip_norm=grad_clip_norm or None, fused=fused)


@dataclasses.dataclass
class TrainState:
    """The model (fp32 parameters, updated in place), the host step count
    and the optimizer's state."""

    step: int
    model: ClipCapModel
    opt_state: AdamWState


def create_train_state(model: ClipCapModel, tx: AdamW) -> TrainState:
    """Turn gradients on for what ``tx`` trains (off for the rest) and
    start the optimizer at zero moments on the model's device."""
    trained = {name for name, _ in tx.trained(model)}
    for name, p in model.named_parameters():
        p.requires_grad_(name in trained)
    return TrainState(step=0, model=model, opt_state=tx.init(model))
