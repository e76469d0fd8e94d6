"""Prefix training: ``train/step.py::train_step`` on seeded batches.

One unit is one training step (the loss through the mapper and the frozen
GPT-2, its gradients, the fused AdamW update) on a batch kept on the
device; steps are issued back to back, as the trainer issues them, and the
window ends with a synchronise.  Set-up builds the one model and optimizer
state that the window then drives, and takes it through its first three
steps with the window's own call, on three different batches: those steps
are the warm-up and what the check compares.

The check: the plain float32 reference (``reference/train.py``) takes the
same three steps from the same seed, and three numbers are compared, each
by its worst case:

* ``loss_rel``: each step's loss, relative to the reference's;
* ``grad_gap``: per trained leaf, the norm of the first gradient as the
  optimizer got it (its first moment after one step, over 1 - b1) against
  the reference's norm, the gap divided by the larger of the reference
  leaf's norm and the median leaf's;
* ``update_gap``: the same for the norm of each leaf's change over the
  three steps, read before step 4 moves it; leaves whose reference
  gradient is under a thousandth of the median leaf's are left out.
"""
from __future__ import annotations

import torch

from clipcap_tpu_torch.train.state import B1, create_train_state, make_optimizer
from clipcap_tpu_torch.train import step as step_mod

from portbench import program, weights
from portbench.kinds import common
from portbench.reference.numerics import Numerics, fp32
from portbench.reference.train import adamw_step, clipcap_loss, linear_schedule
from portbench.traffic import generate

ITEM = "samples"
CHECKED_STEPS = 3


def _initial(cfg: dict, seed: int, device, lm: bool = True) -> dict:
    """The model's starting weights, by the model's parameter names (the
    language model's only with ``lm``)."""
    out = {f"transformer_mapper.{k}": v for k, v in
           weights.mapper(cfg, seed, device, torch.float32).items()}
    if lm:
        out.update({f"language_model.{k}": v for k, v in
                    weights.gpt2(cfg, seed, device, torch.float32).items()})
    return out


class Cell:
    def __init__(self, cfg: dict, traffic: dict, spec: dict, seed: int, device):
        self.cfg, self.traffic, self.spec, self.seed, self.device = cfg, traffic, spec, seed, device
        self.dtype = program.DTYPES[cfg["dtype"]]
        t = traffic
        self.tx = make_optimizer(t["lr"], t["warmup_steps"], t["total_steps"],
                                 train_language_model=t["train_language_model"],
                                 fused=t["fused_optimizer"])
        self.state = create_train_state(program.clipcap(cfg, seed, device, torch.float32), self.tx)
        self.batches = generate.train(t, cfg["mapper"]["encoder_embedding_size"],
                                      cfg["language_model"]["eos_token_id"], seed, device)
        self.items_per_unit = t["batch"]
        self.warm_units = CHECKED_STEPS
        self.losses = []

    def run(self, i: int) -> None:
        tokens, emb = self.batches[i % len(self.batches)]
        loss = step_mod.train_step(self.state, tokens, emb, tx=self.tx, dtype=self.dtype,
                                   remat=self.traffic["remat"])
        if len(self.losses) < CHECKED_STEPS:
            self.losses.append(loss)

    def warmup(self) -> None:
        """The first three steps; the first gradient's leaf norms after the
        first, each leaf's change after the third."""
        mu = self.state.opt_state.mu
        self.run(0)
        self.grad_norms = torch.stack([m.norm() for m in mu.values()]) / (1 - B1)
        for i in range(1, CHECKED_STEPS):
            self.run(i)
        params = dict(self.state.model.named_parameters())
        with torch.no_grad():
            p0 = _initial(self.cfg, self.seed, self.device,
                          lm=any(n.startswith("language_model.") for n in mu))
            self.change_norms = torch.stack([(params[n] - p0[n]).norm() for n in mu])
            del p0
        self.losses = [float(x) for x in self.losses]

    def finish(self) -> None:
        common.sync(self.device)

    def spans(self):
        """A span around each step (``train_step`` as the trainer calls it)."""
        def train_step(*args, **kwargs):
            with torch.profiler.record_function("pb:train_step"):
                return orig(*args, **kwargs)

        orig = step_mod.train_step
        return common.patched(step_mod, "train_step", train_step)

    def work(self, units: int) -> dict:
        return {"kind": "train", "units": units, "batch": self.traffic["batch"],
                "tokens": self.traffic["tokens"],
                "train_language_model": self.traffic["train_language_model"]}

    def release(self) -> None:
        self.names = list(self.state.opt_state.mu)
        self.grad_norms, self.change_norms = self.grad_norms.cpu(), self.change_norms.cpu()
        del self.state, self.batches

    # -- the check ----------------------------------------------------------

    def _reference(self, mode: str):
        """Three reference steps: losses, first-gradient and change norms
        per leaf.  ``fp8``: the control; ``half``: a step that takes the
        mean over half of each batch (a planted fault)."""
        dev, cfg, t = self.device, self.cfg, self.traffic
        num = Numerics("fp8" if mode == "fp8" else "fp32")
        batches = generate.train(t, cfg["mapper"]["encoder_embedding_size"],
                                 cfg["language_model"]["eos_token_id"], self.seed, dev)
        W = _initial(cfg, self.seed, dev)
        for n in self.names:
            W[n] = W[n].clone().requires_grad_(True)
        leaves = [W[n] for n in self.names]
        p0 = [p.detach().clone() for p in leaves]
        Wm = {k[len("transformer_mapper."):]: v for k, v in W.items()
              if k.startswith("transformer_mapper.")}
        Wlm = {k[len("language_model."):]: v for k, v in W.items()
               if k.startswith("language_model.")}
        mu = [torch.zeros_like(p) for p in leaves]
        nu = [torch.zeros_like(p) for p in leaves]
        losses = []
        with fp32():
            for c in range(1, CHECKED_STEPS + 1):
                tokens, emb = batches[c - 1]
                if mode == "half":
                    tokens, emb = tokens[: len(tokens) // 2], emb[: len(emb) // 2]
                loss = clipcap_loss(Wm, Wlm, tokens, emb, cfg, num)
                grads = torch.autograd.grad(loss, leaves)
                losses.append(float(loss.detach()))
                if c == 1:
                    g_norms = torch.stack([g.norm() for g in grads])
                adamw_step(leaves, grads, mu, nu, c,
                           linear_schedule(t["lr"], t["warmup_steps"], t["total_steps"], c - 1))
                del loss, grads
        with torch.no_grad():
            d_norms = torch.stack([(p - q).norm() for p, q in zip(leaves, p0)])
        return losses, g_norms.cpu(), d_norms.cpu()

    def readings(self, modes=("fp32",)) -> dict:
        ref = self._reference("fp32")
        out = _compare((self.losses, self.grad_norms, self.change_norms), ref)
        for mode in modes:
            if mode != "fp32":
                tag = "ctrl." if mode == "fp8" else f"{mode}."
                out.update({tag + k: v for k, v in _compare(self._reference(mode), ref).items()})
        return out


def _compare(got, ref) -> dict:
    (loss_g, g_g, d_g), (loss_r, g_r, d_r) = got, ref
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss_g, loss_r))
    g_floor = torch.maximum(g_r, g_r.median())
    keep = g_r >= 1e-3 * g_r.median()
    d_floor = torch.maximum(d_r, d_r[keep].median())
    return {"loss_rel": loss_rel,
            "grad_gap": float(((g_g - g_r).abs() / g_floor).max()),
            "update_gap": float(((d_g - d_r).abs() / d_floor)[keep].max()),
            "left_out": int((~keep).sum())}
