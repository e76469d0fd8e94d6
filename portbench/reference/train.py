"""Plain ClipCap loss and AdamW, for the training check.

Loss (ClipCap ``train.py``): the mapper's prefix, then the caption's token
embeddings, through GPT-2; the logits at positions ``P-1 .. P+T-2`` predict
the T tokens; mean cross-entropy over the real tokens.  Departure noted:
ClipCap pads with 0 and ignores token 0, the port (like the JAX package)
pads with -1 and ignores only pads; the benchmark's tokens are drawn from
``[1, eos)``, where the two agree.  Pads come after a row's tokens, so
causal attention never lets a real position see a pad, and no pad mask is
needed.

AdamW as optax's ``adamw`` (which the ClipCap port follows): moments
``m = b1·m + (1-b1)·g``, ``v = b2·v + (1-b2)·g²``; bias-corrected update
``m̂ / (√v̂ + eps) + wd·p``, scaled by the learning rate of the 0-based
step from HF's linear warm-up/decay schedule.
"""
from __future__ import annotations

import torch

from portbench.reference.gpt2 import gpt2_hidden, lm_logits, token_embeds
from portbench.reference.mapper import mapper_prefix
from portbench.reference.numerics import Numerics

Tensor = torch.Tensor


def clipcap_loss(Wm: dict, Wlm: dict, tokens: Tensor, emb: Tensor, cfg: dict,
                 num: Numerics) -> Tensor:
    """Mean next-token cross-entropy of ``tokens`` [B, T] (-1 pads) given
    ``emb`` [B, E]."""
    P = cfg["mapper"]["prefix_length"]
    mask = tokens >= 0
    ids = tokens.clamp_min(0)
    prefix = mapper_prefix(Wm, emb, cfg["mapper"], num)
    x = torch.cat([prefix, token_embeds(Wlm, ids)], dim=1)
    h = gpt2_hidden(Wlm, x, cfg["language_model"], num)
    T = tokens.shape[1]
    logp = torch.log_softmax(lm_logits(Wlm, h[:, P - 1:P - 1 + T], num), dim=-1)
    nll = -logp.gather(-1, ids[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum()


def linear_schedule(lr: float, warmup: int, total: int, step: int) -> float:
    """HF ``get_linear_schedule_with_warmup`` at the 0-based ``step``."""
    warm = max(1, warmup)
    total = max(warm + 1, total)
    if step < warm:
        return lr * step / warm
    return lr * max(0.0, (total - step) / max(1, total - warm))


def adamw_step(params: list, grads: list, mu: list, nu: list, count: int, lr: float,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, wd: float = 0.01):
    """One AdamW update in place; ``count`` is the 1-based step."""
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, mu, nu):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            m_hat = m / (1 - b1 ** count)
            v_hat = v / (1 - b2 ** count)
            p.sub_(lr * (m_hat / (v_hat.sqrt() + eps) + wd * p))
