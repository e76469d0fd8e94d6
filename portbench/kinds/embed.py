"""Image embedding: images → CLIP image tower, as preprocess runs it.

One unit is one call of ``encoders/clip.py::CLIPEncoder`` on a batch of
uint8 images staged in host memory: the host → device copy, the tower
(``models/clip_vit.py``: the patch-embed kernel, the blocks with the
attention kernel), the embeddings back as numpy.  The last result of each
distinct batch is kept for the check.

The check, after the window: ``embed_rel``, the relative L2 error of each
sampled image's embedding (``check_images`` drawn from the seed) against
the plain float32 reference tower on the same image, worst image.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench import program, weights
from portbench.kinds import common
from portbench.reference.clip_vit import vit_encode
from portbench.reference.numerics import Numerics, fp32
from portbench.traffic import generate

ITEM = "embeds"


class Cell:
    def __init__(self, cfg: dict, traffic: dict, spec: dict, seed: int, device):
        self.cfg, self.traffic, self.spec, self.seed, self.device = cfg, traffic, spec, seed, device
        self.dtype = program.DTYPES[cfg["dtype"]]
        self.encoder = program.image_encoder(cfg, seed, device, self.dtype)
        self.images = generate.images(traffic, cfg["encoder"]["image_size"], seed, device)
        self.items_per_unit = traffic["batch"]
        self.last = {}

    def run(self, i: int) -> None:
        j = i % len(self.images)
        self.last[j] = self.encoder(self.images[j])

    def warmup(self) -> None:
        self.run(0)

    def finish(self) -> None:
        common.sync(self.device)

    def spans(self):
        return contextlib.nullcontext()

    def work(self, units: int) -> dict:
        return {"kind": "embed", "units": units, "batch": self.traffic["batch"]}

    def release(self) -> None:
        del self.encoder

    def readings(self, modes=("fp32",)) -> dict:
        dev, cfg = self.device, self.cfg
        pairs = [(j, r) for j in sorted(self.last) for r in range(self.traffic["batch"])]
        rng = np.random.default_rng(weights.sub_seed(self.seed, "sample"))
        picks = [pairs[k] for k in sorted(rng.choice(len(pairs), self.spec["check_images"],
                                                     replace=False))]
        imgs = torch.as_tensor(np.stack([self.images[j][r] for j, r in picks]), device=dev)
        emb_p = torch.as_tensor(np.stack([self.last[j][r] for j, r in picks]), device=dev)
        out = {}
        with torch.no_grad(), fp32():
            Wc = {k: v.float() for k, v in weights.clip_visual(cfg, self.seed, dev,
                                                               self.dtype).items()}
            e_ref = common.blocks(lambda x: vit_encode(Wc, x, cfg["encoder"], Numerics("fp32")),
                                  imgs, 32)
            out["embed_rel"] = common.worst_rel(emb_p, e_ref)
            if "fp8" in modes:
                e_c = common.blocks(lambda x: vit_encode(Wc, x, cfg["encoder"], Numerics("fp8")),
                                    imgs, 32)
                out["ctrl.embed_rel"] = common.worst_rel(e_c, e_ref)
        return out
