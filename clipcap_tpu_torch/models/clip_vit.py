"""OpenAI CLIP in PyTorch: ViT image tower + causal text tower.

Counterpart of ``clipcap_tpu/models/clip_vit.py`` for the ViT presets.
:class:`CLIP` holds the weights under OpenAI checkpoint keys
(``visual.conv1.weight``, ``visual.transformer.resblocks.{i}.attn.in_proj_weight``,
``transformer.resblocks.{i}…``, ``text_projection``, ``logit_scale`` …), so
``clipcap_tpu.models.clip_vit.clip_params_from_openai`` reads its state
dict and an OpenAI checkpoint loads with ``load_state_dict``.

Images arrive uint8 ``[B, H, W, 3]``; the /255 and the channel
normalisation are folded into the patch weights, and in bf16 the patch
embedding goes through ``ops.patch_embed.patch_embed``.  Every block's
attention but the last image block's goes through
``ops.attention.sdpa_packed``.  Both are CUDA kernels for tensors on the
card.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from clipcap_tpu_torch.ops.attention import sdpa_packed
from clipcap_tpu_torch.ops.layers import (LayerNorm, Linear, empty_param, in_out, linear,
                                          normal_init, ones_init, quick_gelu, zeros_init)
from clipcap_tpu_torch.ops.patch_embed import patch_embed, patch_embed_supported, patchify
from clipcap_tpu_torch.ops.quant import int8_linear

Tensor = torch.Tensor

# OpenAI CLIP pixel normalisation.
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def n_patches(self) -> int:
        return self.grid * self.grid


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    embed_dim: int = 512


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str
    vision: CLIPVisionConfig
    text: CLIPTextConfig


def _preset(name, *, image_size, patch, vwidth, vlayers, vheads, embed,
            twidth, tlayers, theads) -> CLIPConfig:
    return CLIPConfig(
        name=name,
        vision=CLIPVisionConfig(image_size=image_size, patch_size=patch, width=vwidth,
                                layers=vlayers, heads=vheads, embed_dim=embed),
        text=CLIPTextConfig(width=twidth, layers=tlayers, heads=theads, embed_dim=embed),
    )


CLIP_PRESETS: Dict[str, CLIPConfig] = {
    "ViT-B/32": _preset("ViT-B/32", image_size=224, patch=32, vwidth=768, vlayers=12,
                        vheads=12, embed=512, twidth=512, tlayers=12, theads=8),
    "ViT-B/16": _preset("ViT-B/16", image_size=224, patch=16, vwidth=768, vlayers=12,
                        vheads=12, embed=512, twidth=512, tlayers=12, theads=8),
    "ViT-L/14": _preset("ViT-L/14", image_size=224, patch=14, vwidth=1024, vlayers=24,
                        vheads=16, embed=768, twidth=768, tlayers=12, theads=12),
    "ViT-L/14@336px": _preset("ViT-L/14@336px", image_size=336, patch=14, vwidth=1024,
                              vlayers=24, vheads=16, embed=768, twidth=768, tlayers=12,
                              theads=12),
    # Test-scale preset (not an OpenAI model).
    "test-tiny": _preset("test-tiny", image_size=32, patch=16, vwidth=64, vlayers=2,
                         vheads=4, embed=32, twidth=64, tlayers=2, theads=4),
}


def get_clip_config(variant: str) -> CLIPConfig:
    variant = variant.replace("_", "/")
    if variant in CLIP_PRESETS:
        return CLIP_PRESETS[variant]
    if variant.startswith(("RN", "test-tiny-rn")):
        raise NotImplementedError(f"CLIP '{variant}': the ResNet towers are not ported "
                                  "yet (ROADMAP.md, queue A)")
    raise ValueError(f"unknown CLIP variant '{variant}'. Known: {sorted(CLIP_PRESETS)}")


# ---------------------------------------------------------------------------
# Seeded init (the JAX package's parameter tree, numpy)
# ---------------------------------------------------------------------------


def _blocks_init(rng, L: int, D: int) -> dict:
    def ln():
        return {"scale": ones_init((L, D)), "bias": zeros_init((L, D))}

    return {
        "ln_1": ln(),
        "attn": {
            "in_proj": {"w": normal_init(rng, (L, D, 3 * D)), "b": zeros_init((L, 3 * D))},
            "out_proj": {"w": normal_init(rng, (L, D, D)), "b": zeros_init((L, D))},
        },
        "ln_2": ln(),
        "mlp": {
            "c_fc": {"w": normal_init(rng, (L, D, 4 * D)), "b": zeros_init((L, 4 * D))},
            "c_proj": {"w": normal_init(rng, (L, 4 * D, D)), "b": zeros_init((L, D))},
        },
    }


def init_clip_vision(cfg: CLIPVisionConfig, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    D = cfg.width
    return {
        "patch_embed": {"w": normal_init(rng, (3 * cfg.patch_size ** 2, D), std=D ** -0.5)},
        "class_embedding": normal_init(rng, (D,), std=D ** -0.5),
        "positional_embedding": normal_init(rng, (cfg.n_patches + 1, D), std=0.01),
        "ln_pre": {"scale": ones_init((D,)), "bias": zeros_init((D,))},
        "blocks": _blocks_init(rng, cfg.layers, D),
        "ln_post": {"scale": ones_init((D,)), "bias": zeros_init((D,))},
        "proj": normal_init(rng, (D, cfg.embed_dim), std=D ** -0.5),
    }


def init_clip_text(cfg: CLIPTextConfig, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    D = cfg.width
    return {
        "token_embedding": normal_init(rng, (cfg.vocab_size, D), std=0.02),
        "positional_embedding": normal_init(rng, (cfg.context_length, D), std=0.01),
        "blocks": _blocks_init(rng, cfg.layers, D),
        "ln_final": {"scale": ones_init((D,)), "bias": zeros_init((D,))},
        "text_projection": normal_init(rng, (D, cfg.embed_dim), std=D ** -0.5),
    }


def init_clip(cfg: CLIPConfig, seed: int = 0) -> dict:
    """The same draws as ``clipcap_tpu.models.clip_vit.init_clip``."""
    return {
        "visual": init_clip_vision(cfg.vision, seed),
        "text": init_clip_text(cfg.text, seed + 1),
        "logit_scale": np.asarray(np.log(1.0 / 0.07), np.float32),
    }


# ---------------------------------------------------------------------------
# Modules (OpenAI keys)
# ---------------------------------------------------------------------------


class _MultiheadAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.in_proj_weight = empty_param(3 * d, d)
        self.in_proj_bias = empty_param(3 * d)
        self.out_proj = Linear(d, d)


class _MLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.c_fc = Linear(d, 4 * d)
        self.c_proj = Linear(4 * d, d)


class _ResidualBlock(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.ln_1 = LayerNorm(d)
        self.attn = _MultiheadAttention(d)
        self.ln_2 = LayerNorm(d)
        self.mlp = _MLP(d)


class _Transformer(nn.Module):
    def __init__(self, d: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(_ResidualBlock(d) for _ in range(layers))


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        D, p = cfg.width, cfg.patch_size
        self.conv1 = nn.Module()
        self.conv1.weight = empty_param(D, 3, p, p)
        self.class_embedding = empty_param(D)
        self.positional_embedding = empty_param(cfg.n_patches + 1, D)
        self.ln_pre = LayerNorm(D)
        self.transformer = _Transformer(D, cfg.layers)
        self.ln_post = LayerNorm(D)
        self.proj = empty_param(D, cfg.embed_dim)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.config = cfg
        t = cfg.text
        self.visual = VisionTransformer(cfg.vision)
        self.token_embedding = nn.Module()
        self.token_embedding.weight = empty_param(t.vocab_size, t.width)
        self.positional_embedding = empty_param(t.context_length, t.width)
        self.transformer = _Transformer(t.width, t.layers)
        self.ln_final = LayerNorm(t.width)
        self.text_projection = empty_param(t.width, t.embed_dim)
        self.logit_scale = empty_param(())


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _project(x: Tensor, weight, bias: Tensor, int8_acts: bool) -> Tensor:
    """A block projection; ``weight`` in ``Linear`` layout ``[out, in]``, or
    an ``Int8Weight``.  ``int8_acts``: the w8a8 product (``ops.quant``)."""
    if int8_acts:
        return int8_linear(x, weight, bias)
    return linear(x, in_out(weight), bias)


def _qkv(x: Tensor, block: _ResidualBlock, int8_acts: bool) -> Tensor:
    return _project(block.ln_1(x), block.attn.in_proj_weight, block.attn.in_proj_bias,
                    int8_acts)


def _finish_block(x: Tensor, attn: Tensor, block: _ResidualBlock, int8_acts: bool) -> Tensor:
    out_proj, mlp = block.attn.out_proj, block.mlp
    x = x + _project(attn, out_proj.weight, out_proj.bias, int8_acts)
    h = quick_gelu(_project(block.ln_2(x), mlp.c_fc.weight, mlp.c_fc.bias, int8_acts))
    return x + _project(h, mlp.c_proj.weight, mlp.c_proj.bias, int8_acts)


def _clip_block(x: Tensor, block: _ResidualBlock, heads: int, causal: bool = False,
                int8_acts: bool = False) -> Tensor:
    """Pre-norm block: biased MHA through the packed-qkv kernel wrapper,
    QuickGELU MLP."""
    attn = sdpa_packed(_qkv(x, block, int8_acts), heads, causal=causal)
    return _finish_block(x, attn, block, int8_acts)


def _clip_block_cls(x: Tensor, block: _ResidualBlock, heads: int,
                    int8_acts: bool = False) -> Tensor:
    """The final image block restricted to the class-token row (the only
    row ``clip_encode_image`` keeps): q for row 0 only, k/v over all rows,
    the MLP on one token.  Returns [B, D]."""
    B, N, D = x.shape
    Dh = D // heads
    q, k, v = (t.reshape(B, N, heads, Dh)
               for t in _qkv(x, block, int8_acts).split(D, dim=-1))
    logits = torch.einsum("bnhd,bmhd->bhnm", q[:, :1], k) * Dh ** -0.5
    w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    a = torch.einsum("bhnm,bmhd->bnhd", w, v).reshape(B, 1, D)
    return _finish_block(x[:, :1], a, block, int8_acts)[:, 0]


def clip_encode_image(visual: VisionTransformer, images: Tensor, *,
                      dtype=torch.float32, normalize_pixels: bool = True,
                      int8_acts: bool = False) -> Tensor:
    """ViT forward → [B, embed_dim] (``model.encode_image``).  ``images``:
    [B, H, W, 3] uint8 (or float in [0, 1]).  In bf16, uint8 images whose
    sides divide by the patch take the patch-embed kernel wrapper (the CUDA
    kernel for tensors on the card); every other input the eager
    ``patchify`` + ``linear``.

    ``int8_acts`` runs the block projections as w8a8 products
    (``ops.quant.int8_linear``); the blocks must then hold the int8 weights
    of ``ops.quant.quantize_clip_visual_int8``.  Attention, layer norms,
    the patch embedding and the final projection stay in ``dtype``."""
    cfg = visual.config
    D, p = cfg.width, cfg.patch_size
    w32 = visual.conv1.weight.float().reshape(D, -1).t()        # [3·p·p, D]
    w, bias0 = w32.to(dtype), None
    if normalize_pixels:
        # ((x - mean)/std) @ W == x @ (W/std) - (mean/std) @ W: the
        # normalisation (and uint8's /255) costs a pass over the weight,
        # not over the pixels.
        pp = p * p
        mean = torch.tensor(IMAGE_MEAN, device=w32.device).repeat_interleave(pp)
        std = torch.tensor(IMAGE_STD, device=w32.device).repeat_interleave(pp)
        scale = 1.0 / std
        if images.dtype == torch.uint8:
            scale = scale / 255.0
        w = (w32 * scale[:, None]).to(dtype)
        bias0 = (-(mean / std) @ w32).to(dtype)
    if dtype == torch.bfloat16 and patch_embed_supported(images, p):
        # Without the normalisation fold the uint8 /255 folds into the
        # weight the same way, and there is no bias.
        wk, bk = (w, bias0) if normalize_pixels else ((w32 / 255.0).to(dtype), None)
        x = patch_embed(images, wk.contiguous(), bk, p)
    else:
        x = images.to(dtype)
        if not normalize_pixels and images.dtype == torch.uint8:
            x = x / 255.0
        x = linear(patchify(x, p), w, bias0)                    # [B, N, D]

    B = x.shape[0]
    cls = visual.class_embedding.to(dtype)[None, None].expand(B, 1, D)
    x = torch.cat([cls, x], dim=1) + visual.positional_embedding.to(dtype)[None]
    x = visual.ln_pre(x)
    *body, last = visual.transformer.resblocks
    for block in body:
        x = _clip_block(x, block, cfg.heads, int8_acts=int8_acts)
    x = visual.ln_post(_clip_block_cls(x, last, cfg.heads, int8_acts))
    return x @ visual.proj.to(x.dtype)


def clip_encode_text(clip: CLIP, tokens: Tensor, *, dtype=torch.float32) -> Tensor:
    """Causal text transformer → [B, embed_dim] (``model.encode_text``);
    ``tokens`` [B, context_length], zero-padded after the EOT token."""
    cfg = clip.config.text
    x = torch.nn.functional.embedding(tokens.long(), clip.token_embedding.weight).to(dtype)
    x = x + clip.positional_embedding.to(dtype)[None]
    for block in clip.transformer.resblocks:
        x = _clip_block(x, block, cfg.heads, causal=True)
    x = clip.ln_final(x)
    eot = tokens.argmax(dim=-1)                  # EOT = the largest token id
    x = x[torch.arange(x.shape[0], device=x.device), eot]
    return x @ clip.text_projection.to(x.dtype)


def clip_similarity(clip: CLIP, images: Tensor, tokens: Tensor, *,
                    dtype=torch.float32, int8_acts: bool = False) -> Tuple[Tensor, Tensor]:
    """Scaled cosine-similarity logits ``(logits_per_image, logits_per_text)``.
    ``int8_acts`` as :func:`clip_encode_image`'s: a visual tower quantised
    for w8a8 reranks through the same path it embeds with."""
    img = clip_encode_image(clip.visual, images, dtype=dtype, int8_acts=int8_acts)
    txt = clip_encode_text(clip, tokens, dtype=dtype)
    img = img / img.norm(dim=-1, keepdim=True)
    txt = txt / txt.norm(dim=-1, keepdim=True)
    logits_per_image = clip.logit_scale.exp().to(img.dtype) * img @ txt.t()
    return logits_per_image, logits_per_image.t()


# ---------------------------------------------------------------------------
# Weights: a local OpenAI checkpoint, else a seed
# ---------------------------------------------------------------------------


def clip_config_from_openai(sd) -> CLIPConfig:
    """A ViT config inferred from an OpenAI state dict's shapes."""
    if "visual.attnpool.positional_embedding" in sd:
        raise NotImplementedError("ResNet CLIP checkpoints are not ported yet "
                                  "(ROADMAP.md, queue A)")
    conv = sd["visual.conv1.weight"]
    vwidth, patch = conv.shape[0], conv.shape[-1]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))

    def n_layers(prefix, index):
        return len({k.split(".")[index] for k in sd if k.startswith(prefix)})

    embed = sd["text_projection"].shape[1]
    twidth = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        name=f"ViT-{vwidth}/{patch}",
        vision=CLIPVisionConfig(image_size=grid * patch, patch_size=patch, width=vwidth,
                                layers=n_layers("visual.transformer.resblocks.", 3),
                                heads=vwidth // 64, embed_dim=embed),
        text=CLIPTextConfig(vocab_size=sd["token_embedding.weight"].shape[0],
                            context_length=sd["positional_embedding"].shape[0],
                            width=twidth, layers=n_layers("transformer.resblocks.", 2),
                            heads=twidth // 64, embed_dim=embed),
    )


def _load_openai_checkpoint(path: str) -> dict:
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=False)
    return {k: v.float() for k, v in sd.items() if torch.is_tensor(v)}


def load_clip(variant: str, checkpoint_path: Optional[str] = None,
              device="cpu") -> Tuple[CLIP, CLIPConfig]:
    """CLIP weights from ``checkpoint_path``, ``$CLIPCAP_CLIP_CHECKPOINT`` or
    ``~/.cache/clip/<variant>.pt`` (an OpenAI checkpoint), else seeded
    random weights with a warning."""
    from clipcap_tpu_torch.convert import clip_from_params

    cfg = get_clip_config(variant)
    if not cfg.name.startswith("test-tiny"):
        for path in (checkpoint_path, os.environ.get("CLIPCAP_CLIP_CHECKPOINT"),
                     os.path.expanduser(f"~/.cache/clip/{variant.replace('/', '-')}.pt")):
            if path and os.path.exists(path):
                sd = _load_openai_checkpoint(path)
                cfg = clip_config_from_openai(sd)
                model = CLIP(cfg)
                model.load_state_dict({k: v for k, v in sd.items()
                                       if k in model.state_dict()})
                return model.to(device), cfg
        warnings.warn(
            f"Could not load pretrained CLIP '{variant}' (offline, no local "
            "checkpoint). Using RANDOM weights — fine for benchmarks, wrong for "
            "real captioning.")
    return clip_from_params(init_clip(cfg), cfg).to(device), cfg
