"""OpenAI CLIP ModifiedResNet image towers in PyTorch (RN50 family).

Counterpart of ``clipcap_tpu/models/clip_resnet.py``: RN50, RN101, RN50x4,
RN50x16 and RN50x64 beside the ViTs; the text side is the ViTs' causal
transformer (``models/clip_vit.py``).  The architecture:

* a 3-conv stem (3×3 stride 2, then two 3×3) with BatchNorm + ReLU after
  each, then a 2×2 average pool;
* four bottleneck stages with expansion 4 and anti-aliased downsampling:
  a stride-1 3×3 conv followed by a stride-sized average pool, and on the
  shortcut the pool BEFORE the 1×1 projection;
* a multi-head attention pool over the final grid, with a learned
  positional embedding, querying from the mean-pooled token.

:class:`ModifiedResNet` holds OpenAI's keys (``conv1.weight``,
``bn1.running_var``, ``layer1.0.downsample.0.weight``,
``attnpool.q_proj.weight`` … under ``visual.``), four tensors per batch
norm; the forward folds each into ``x·scale + shift`` in fp64, as the JAX
package folds them at import.  Convolutions are ``F.conv2d`` on
``channels_last`` activations (cuDNN on the card); the JAX package runs
them as XLA convolutions, not Pallas kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clipcap_tpu_torch.ops.layers import BatchNorm, Conv, Linear, empty_param

Tensor = torch.Tensor

EXPANSION = 4  # bottleneck expansion factor


@dataclasses.dataclass(frozen=True)
class CLIPResNetConfig:
    """Vision-side config of a ModifiedResNet tower.  ``width`` is the
    stem's output width; stage c has ``width·2^c`` planes (expansion 4),
    so the attention pool is ``width·32`` wide."""
    image_size: int = 224
    width: int = 64
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    heads: int = 32  # attention-pool heads (width·32/64)
    embed_dim: int = 1024

    @property
    def pool_width(self) -> int:
        return self.width * 32

    @property
    def grid(self) -> int:
        # stem /4 (stride-2 conv + 2×2 pool), stages 2-4 /2 each → /32
        return self.image_size // 32


# ---------------------------------------------------------------------------
# Seeded init (the JAX package's tree: HWIO convs, folded batch norms)
# ---------------------------------------------------------------------------


def _conv_init(rng: np.random.Generator, kh: int, kw: int, cin: int, cout: int) -> np.ndarray:
    bound = 1.0 / np.sqrt(kh * kw * cin)
    return rng.uniform(-bound, bound, (kh, kw, cin, cout)).astype(np.float32)


def _bn_init(n: int) -> dict:
    return {"scale": np.ones((n,), np.float32), "bias": np.zeros((n,), np.float32)}


def _block_init(rng, cin: int, planes: int, downsample: bool) -> dict:
    p = {
        "conv1": {"w": _conv_init(rng, 1, 1, cin, planes)}, "bn1": _bn_init(planes),
        "conv2": {"w": _conv_init(rng, 3, 3, planes, planes)}, "bn2": _bn_init(planes),
        "conv3": {"w": _conv_init(rng, 1, 1, planes, planes * EXPANSION)},
        "bn3": _bn_init(planes * EXPANSION),
    }
    if downsample:
        p["downsample"] = {"conv": {"w": _conv_init(rng, 1, 1, cin, planes * EXPANSION)},
                           "bn": _bn_init(planes * EXPANSION)}
    return p


def stack_trees(trees):
    """Trees of one structure → one tree with each leaf stacked on a new
    first axis (the JAX package's stacked ``tail`` of identical blocks)."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def init_clip_resnet(cfg: CLIPResNetConfig, seed: int = 0) -> dict:
    """The same draws as ``clipcap_tpu.models.clip_resnet.init_clip_resnet``."""
    rng = np.random.default_rng(seed)
    w = cfg.width
    stem = {
        "conv1": {"w": _conv_init(rng, 3, 3, 3, w // 2)}, "bn1": _bn_init(w // 2),
        "conv2": {"w": _conv_init(rng, 3, 3, w // 2, w // 2)}, "bn2": _bn_init(w // 2),
        "conv3": {"w": _conv_init(rng, 3, 3, w // 2, w)}, "bn3": _bn_init(w),
    }
    stages = []
    cin = w
    for s, n_blocks in enumerate(cfg.layers):
        planes = w * 2 ** s
        block0 = _block_init(rng, cin, planes, downsample=True)
        cin = planes * EXPANSION
        tail = None
        if n_blocks > 1:
            tail = stack_trees([_block_init(rng, cin, planes, downsample=False)
                           for _ in range(n_blocks - 1)])
        stages.append({"block0": block0, "tail": tail})

    pw = cfg.pool_width
    bound = 1.0 / np.sqrt(pw)

    def lin(nin, nout):
        return {"w": rng.uniform(-bound, bound, (nin, nout)).astype(np.float32),
                "b": np.zeros((nout,), np.float32)}

    attnpool = {
        "positional_embedding": (rng.standard_normal((cfg.grid ** 2 + 1, pw))
                                 / np.sqrt(pw)).astype(np.float32),
        "q_proj": lin(pw, pw), "k_proj": lin(pw, pw), "v_proj": lin(pw, pw),
        "c_proj": lin(pw, cfg.embed_dim),
    }
    return {"stem": stem, "stages": stages, "attnpool": attnpool}


# ---------------------------------------------------------------------------
# Modules (OpenAI keys)
# ---------------------------------------------------------------------------


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, downsample: bool):
        super().__init__()
        out = planes * EXPANSION
        self.conv1 = Conv(cin, planes, 1, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, 3, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, out, 1, 1, bias=False)
        self.bn3 = BatchNorm(out)
        if downsample:
            # OpenAI's Sequential: "-1" the average pool, "0" the conv, "1" the norm
            self.downsample = nn.ModuleDict({"0": Conv(cin, out, 1, 1, bias=False),
                                             "1": BatchNorm(out)})


class AttentionPool(nn.Module):
    def __init__(self, cfg: CLIPResNetConfig):
        super().__init__()
        pw = cfg.pool_width
        self.positional_embedding = empty_param(cfg.grid ** 2 + 1, pw)
        self.q_proj = Linear(pw, pw)
        self.k_proj = Linear(pw, pw)
        self.v_proj = Linear(pw, pw)
        self.c_proj = Linear(pw, cfg.embed_dim)


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: CLIPResNetConfig):
        super().__init__()
        self.config = cfg
        w = cfg.width
        self.conv1 = Conv(3, w // 2, 3, 3, bias=False)
        self.bn1 = BatchNorm(w // 2)
        self.conv2 = Conv(w // 2, w // 2, 3, 3, bias=False)
        self.bn2 = BatchNorm(w // 2)
        self.conv3 = Conv(w // 2, w, 3, 3, bias=False)
        self.bn3 = BatchNorm(w)
        cin = w
        for s, n_blocks in enumerate(cfg.layers):
            planes = w * 2 ** s
            blocks = [Bottleneck(cin, planes, downsample=True)]
            cin = planes * EXPANSION
            blocks += [Bottleneck(cin, planes, downsample=False) for _ in range(n_blocks - 1)]
            setattr(self, f"layer{s + 1}", nn.ModuleList(blocks))
        self.attnpool = AttentionPool(cfg)

    def stages(self):
        return [getattr(self, f"layer{s + 1}") for s in range(len(self.config.layers))]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _conv_bn(x: Tensor, conv: Conv, bn: BatchNorm, stride: int = 1, padding: int = 0) -> Tensor:
    y = F.conv2d(x, conv.weight.to(x.dtype), stride=stride, padding=padding)
    scale, shift = bn.folded()
    return y * scale.to(y.dtype)[:, None, None] + shift.to(y.dtype)[:, None, None]


def _avg_pool(x: Tensor, k: int) -> Tensor:
    return x if k == 1 else F.avg_pool2d(x, k)


def _bottleneck(x: Tensor, block: Bottleneck, stride: int) -> Tensor:
    out = torch.relu(_conv_bn(x, block.conv1, block.bn1))
    out = torch.relu(_conv_bn(out, block.conv2, block.bn2, padding=1))
    out = _avg_pool(out, stride)              # anti-aliased downsample: pool after the 3×3
    out = _conv_bn(out, block.conv3, block.bn3)
    if hasattr(block, "downsample"):
        # the shortcut pools FIRST, then the 1×1 projection (OpenAI's order)
        identity = _conv_bn(_avg_pool(x, stride), block.downsample["0"], block.downsample["1"])
    else:
        identity = x
    return torch.relu(out + identity)


def _attention_pool(x: Tensor, pool: AttentionPool, heads: int) -> Tensor:
    """[B, C, H, W] → [B, embed_dim]: multi-head attention of the mean
    token over itself and the grid, with the learned positional embedding."""
    B, C = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)                          # [B, HW, C]
    x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)    # [B, HW+1, C]
    x = x + pool.positional_embedding.to(x.dtype)[None]
    Dh = C // heads
    q = pool.q_proj(x[:, :1]).reshape(B, 1, heads, Dh)
    k = pool.k_proj(x).reshape(B, -1, heads, Dh)
    v = pool.v_proj(x).reshape(B, -1, heads, Dh)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * Dh ** -0.5
    w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", w, v).reshape(B, 1, C)
    return pool.c_proj(out)[:, 0]


def clip_encode_image_resnet(visual: ModifiedResNet, images: Tensor, *, dtype=torch.float32,
                             normalize_pixels: bool = True) -> Tensor:
    """ModifiedResNet forward → [B, embed_dim] (``model.encode_image`` for
    RN checkpoints).  ``images``: [B, H, W, 3] uint8 or float in [0, 1].

    Pixel normalisation stays an elementwise op (unlike the ViT's weight
    fold): the stem conv has spatial extent and zero padding, so folding
    the shift into a bias would be wrong at the borders."""
    from clipcap_tpu_torch.models.clip_vit import IMAGE_MEAN, IMAGE_STD

    x = images.to(dtype)
    if images.dtype == torch.uint8:
        x = x / torch.tensor(255.0, dtype=dtype, device=x.device)
    if normalize_pixels:
        x = ((x - torch.tensor(IMAGE_MEAN, dtype=dtype, device=x.device))
             / torch.tensor(IMAGE_STD, dtype=dtype, device=x.device))
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    x = torch.relu(_conv_bn(x, visual.conv1, visual.bn1, stride=2, padding=1))
    x = torch.relu(_conv_bn(x, visual.conv2, visual.bn2, padding=1))
    x = torch.relu(_conv_bn(x, visual.conv3, visual.bn3, padding=1))
    x = _avg_pool(x, 2)
    for s, blocks in enumerate(visual.stages()):
        for i, block in enumerate(blocks):
            x = _bottleneck(x, block, 2 if s > 0 and i == 0 else 1)
    return _attention_pool(x, visual.attnpool, visual.config.heads)


# ---------------------------------------------------------------------------
# OpenAI checkpoints
# ---------------------------------------------------------------------------


def resnet_params_from_openai(state_dict, cfg: CLIPResNetConfig) -> dict:
    """The JAX package's tree (numpy; batch norms folded) of the ``visual.*``
    half of an OpenAI RN state dict."""
    from clipcap_tpu_torch.convert import resnet_params

    model = ModifiedResNet(cfg)
    model.load_state_dict({k: torch.as_tensor(state_dict[f"visual.{k}"]).float()
                           for k in model.state_dict()})
    return resnet_params(model)


def resnet_config_from_openai(state_dict) -> CLIPResNetConfig:
    """The RN config from a state dict's shapes (the counting ``clip.load``'s
    ``build_model`` does)."""
    sd = state_dict
    width = sd["visual.layer1.0.conv1.weight"].shape[0]
    layers = tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}.")})
                   for b in (1, 2, 3, 4))
    pos = sd["visual.attnpool.positional_embedding"].shape
    spacial = int(round((pos[0] - 1) ** 0.5))
    return CLIPResNetConfig(image_size=spacial * 32, width=width, layers=layers,
                            heads=pos[1] // 64,
                            embed_dim=sd["visual.attnpool.c_proj.weight"].shape[0])
