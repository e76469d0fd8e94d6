"""HTS-AT audio transformer (the CLAP audio tower) and the CLAP text tower
in PyTorch.

Counterpart of ``clipcap_tpu/models/htsat.py``.  The audio branch is
HTS-AT (Chen et al. 2022), a Swin transformer over a log-mel "image":

  48 kHz mono → log-mel [1001, 64] → per-mel-bin batch norm → bicubic
  resize and time/freq fold to a 256×256 image (freq_ratio 4) → 4×4 patch
  embed (dim 96) → Swin stages depths (2, 2, 6, 2), heads (4, 8, 16, 32),
  window 8, relative position bias, shifted windows → final norm → token
  mean-pool (768) → the CLAP audio projection MLP (768 → 512 → 512).

The modules hold the weights under laion_clap's checkpoint keys:
:class:`CLAPAudio` ``audio_branch.*`` (:class:`HTSAT`) and
``audio_projection.{0,2}.*``, :class:`CLAPText` ``text_branch.*`` (HF
RoBERTa) and ``text_projection.{0,2}.*``; together they are a laion_clap
state dict.  Fusion checkpoints (``mel_conv2d``, ``fusion_model``) take
>10 s audio as the ``[4, 1001, 64]`` input of ``ops.audio.build_mel_fusion``
and merge local-chunk features into the patch embedding by AFF.

Window attention is eager, as the JAX package computes it (an ``einsum``);
no hand kernel runs in this tower.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clipcap_tpu_torch.models.roberta import Roberta, RobertaConfig, init_roberta, roberta_apply
from clipcap_tpu_torch.ops.audio import CLAP_CLIP_SAMPLES, log_mel_spectrogram
from clipcap_tpu_torch.ops.layers import BatchNorm, Conv, LayerNorm, Linear, empty_param, linear

Tensor = torch.Tensor

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class HTSATConfig:
    spec_size: int = 256
    patch_size: int = 4
    in_chans: int = 1
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    freq_ratio: int = 4
    n_mels: int = 64
    embedding_dim: int = 512   # CLAP joint space
    latent_dim: int = 768      # embed_dim * 2**(n_stages-1)
    enable_fusion: bool = False  # laion_clap fusion variant (>10 s audio)
    name: str = "HTSAT-tiny"


CLAP_PRESETS = {
    "HTSAT-tiny": HTSATConfig(),
    # test-scale preset: a tiny Swin for tests and smoke runs
    "test-tiny": HTSATConfig(spec_size=64, embed_dim=16, depths=(1, 1),
                             heads=(2, 4), window_size=4, freq_ratio=4,
                             latent_dim=32, embedding_dim=16, name="test-tiny"),
}


def get_htsat_config(variant: str) -> HTSATConfig:
    if variant in CLAP_PRESETS:
        return CLAP_PRESETS[variant]
    raise ValueError(f"unknown CLAP audio variant '{variant}'. Known: {sorted(CLAP_PRESETS)}")


# ---------------------------------------------------------------------------
# Seeded init (the JAX package's trees, numpy, drawn in its order)
# ---------------------------------------------------------------------------


def _trunc_normal(rng, shape, std=0.02):
    return np.clip(rng.normal(0, std, size=shape), -2 * std, 2 * std).astype(np.float32)


def _ln(n):
    return {"scale": np.ones((n,), np.float32), "bias": np.zeros((n,), np.float32)}


def _bn(n):
    return {"scale": np.ones((n,), np.float32), "bias": np.zeros((n,), np.float32),
            "mean": np.zeros((n,), np.float32), "var": np.ones((n,), np.float32)}


def init_htsat(cfg: HTSATConfig, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    n_stages = len(cfg.depths)
    ws = cfg.window_size
    p = cfg.patch_size

    params = {
        "bn0": _bn(cfg.n_mels),
        "patch_embed": {
            "proj": {"w": _trunc_normal(rng, (p * p * cfg.in_chans, cfg.embed_dim)),
                     "b": np.zeros((cfg.embed_dim,), np.float32)},
            "norm": _ln(cfg.embed_dim),
        },
        "stages": [],
        "norm": _ln(cfg.embed_dim * 2 ** (n_stages - 1)),
        "audio_projection": {
            "fc1": {"w": _trunc_normal(rng, (cfg.latent_dim, cfg.embedding_dim)),
                    "b": np.zeros((cfg.embedding_dim,), np.float32)},
            "fc2": {"w": _trunc_normal(rng, (cfg.embedding_dim, cfg.embedding_dim)),
                    "b": np.zeros((cfg.embedding_dim,), np.float32)},
        },
    }
    if cfg.enable_fusion:
        params["patch_embed"]["mel_conv2d"] = {
            "w": _trunc_normal(rng, (p * 3 * p * cfg.in_chans, cfg.embed_dim)),
            "b": np.zeros((cfg.embed_dim,), np.float32),
        }
        params["patch_embed"]["fusion"] = init_aff(cfg.embed_dim, max(1, cfg.embed_dim // 4),
                                                   rng)

    for s in range(n_stages):
        dim = cfg.embed_dim * 2 ** s
        hidden = int(dim * cfg.mlp_ratio)
        blocks = []
        for _ in range(cfg.depths[s]):
            blocks.append({
                "norm1": _ln(dim),
                "attn": {
                    "qkv": {"w": _trunc_normal(rng, (dim, 3 * dim)),
                            "b": np.zeros((3 * dim,), np.float32)},
                    "proj": {"w": _trunc_normal(rng, (dim, dim)),
                             "b": np.zeros((dim,), np.float32)},
                    "rel_bias": _trunc_normal(rng, ((2 * ws - 1) ** 2, cfg.heads[s])),
                },
                "norm2": _ln(dim),
                "mlp": {
                    "fc1": {"w": _trunc_normal(rng, (dim, hidden)),
                            "b": np.zeros((hidden,), np.float32)},
                    "fc2": {"w": _trunc_normal(rng, (hidden, dim)),
                            "b": np.zeros((dim,), np.float32)},
                },
            })
        stage = {"blocks": blocks}
        if s < n_stages - 1:
            stage["downsample"] = {"norm": _ln(4 * dim),
                                   "reduction": {"w": _trunc_normal(rng, (4 * dim, 2 * dim))}}
        params["stages"].append(stage)
    return params


def init_aff(channels: int, inter: int, rng) -> dict:
    """AFF (attentional feature fusion, Dai et al. 2021), the 2-D variant
    laion_clap's fusion HTSAT uses (``fusion_model``)."""

    def conv(cin, cout):
        return {"w": _trunc_normal(rng, (cin, cout)), "b": np.zeros((cout,), np.float32)}

    return {
        "local": {"conv1": conv(channels, inter), "bn1": _bn(inter),
                  "conv2": conv(inter, channels), "bn2": _bn(channels)},
        "global": {"conv1": conv(channels, inter), "bn1": _bn(inter),
                   "conv2": conv(inter, channels), "bn2": _bn(channels)},
    }


def init_clap_text(embed_dim: int = 512, seed: int = 7):
    """A seeded tiny text tower ``(tree, RobertaConfig)`` (offline smoke
    runs, the test-tiny preset)."""
    cfg = RobertaConfig(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=4,
                        intermediate_size=128, max_position_embeddings=80,
                        name="roberta-test")
    rng = np.random.default_rng(seed)
    text_params = {
        "roberta": init_roberta(cfg, seed=seed),
        "projection": {
            "fc1": {"w": rng.normal(0, 0.02, (64, embed_dim)).astype(np.float32),
                    "b": np.zeros((embed_dim,), np.float32)},
            "fc2": {"w": rng.normal(0, 0.02, (embed_dim, embed_dim)).astype(np.float32),
                    "b": np.zeros((embed_dim,), np.float32)},
        },
    }
    return text_params, cfg


# ---------------------------------------------------------------------------
# Modules (laion_clap keys)
# ---------------------------------------------------------------------------


def _conv_linear(x: Tensor, conv: Conv) -> Tensor:
    """A stride-equals-kernel (or 1×1) conv on patchified channel-last
    input: the flattened weight as a linear."""
    return linear(x, conv.weight.reshape(conv.weight.shape[0], -1).t(), conv.bias)


def _mlp2(n_in: int, n_out: int) -> nn.ModuleDict:
    """``Sequential(Linear, ReLU, Linear)``'s keys: ``0`` and ``2``."""
    return nn.ModuleDict({"0": Linear(n_in, n_out), "2": Linear(n_out, n_out)})


def _mlp2_apply(mlp: nn.ModuleDict, x: Tensor) -> Tensor:
    return mlp["2"](torch.relu(mlp["0"](x)))


class _AFF(nn.Module):
    def __init__(self, channels: int, inter: int):
        super().__init__()
        self.local_att = nn.ModuleDict({"0": Conv(channels, inter, 1, 1), "1": BatchNorm(inter),
                                        "3": Conv(inter, channels, 1, 1),
                                        "4": BatchNorm(channels)})
        self.global_att = nn.ModuleDict({"1": Conv(channels, inter, 1, 1),
                                         "2": BatchNorm(inter),
                                         "4": Conv(inter, channels, 1, 1),
                                         "5": BatchNorm(channels)})


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: HTSATConfig):
        super().__init__()
        D, p = cfg.embed_dim, cfg.patch_size
        self.proj = Conv(cfg.in_chans, D, p, p)
        self.norm = LayerNorm(D)
        if cfg.enable_fusion:
            self.mel_conv2d = Conv(cfg.in_chans, D, p, 3 * p)
            self.fusion_model = _AFF(D, max(1, D // 4))


class _WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = empty_param((2 * ws - 1) ** 2, heads)


class _SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, mlp_ratio: float):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim)
        self.attn = _WindowAttention(dim, heads, ws)
        self.norm2 = LayerNorm(dim)
        self.mlp = nn.Module()
        self.mlp.fc1 = Linear(dim, hidden)
        self.mlp.fc2 = Linear(hidden, dim)


class _Stage(nn.Module):
    def __init__(self, cfg: HTSATConfig, s: int):
        super().__init__()
        dim = cfg.embed_dim * 2 ** s
        self.blocks = nn.ModuleList(_SwinBlock(dim, cfg.heads[s], cfg.window_size,
                                               cfg.mlp_ratio) for _ in range(cfg.depths[s]))
        if s < len(cfg.depths) - 1:
            self.downsample = nn.Module()
            self.downsample.norm = LayerNorm(4 * dim)
            self.downsample.reduction = Linear(4 * dim, 2 * dim, bias=False)


class HTSAT(nn.Module):
    """laion_clap's ``audio_branch`` (``HTSAT_Swin_Transformer``) weights."""

    def __init__(self, cfg: HTSATConfig):
        super().__init__()
        self.config = cfg
        self.bn0 = BatchNorm(cfg.n_mels)
        self.patch_embed = _PatchEmbed(cfg)
        self.layers = nn.ModuleList(_Stage(cfg, s) for s in range(len(cfg.depths)))
        self.norm = LayerNorm(cfg.embed_dim * 2 ** (len(cfg.depths) - 1))


class CLAPAudio(nn.Module):
    """The audio half of a laion_clap checkpoint."""

    def __init__(self, cfg: HTSATConfig):
        super().__init__()
        self.config = cfg
        self.audio_branch = HTSAT(cfg)
        self.audio_projection = _mlp2(cfg.latent_dim, cfg.embedding_dim)


class CLAPText(nn.Module):
    """The text half of a laion_clap checkpoint: RoBERTa + projection."""

    def __init__(self, cfg: RobertaConfig, embed_dim: int):
        super().__init__()
        self.config = cfg
        self.text_branch = Roberta(cfg)
        self.text_projection = _mlp2(cfg.hidden_size, embed_dim)


# ---------------------------------------------------------------------------
# Swin pieces
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _rel_position_index(ws: int) -> np.ndarray:
    """Standard Swin relative-position index [ws², ws²]."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _window_partition(x: Tensor, ws: int) -> Tensor:
    """[B, H, W, C] → [B·nW, ws², C]"""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def _window_reverse(windows: Tensor, ws: int, H: int, W: int) -> Tensor:
    B = windows.shape[0] // (H * W // ws // ws)
    x = windows.reshape(B, H // ws, W // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, -1)


@lru_cache(maxsize=16)
def _shift_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """Attention mask for shifted windows: [nW, ws², ws²] additive."""
    img = np.zeros((H, W))
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[h, w] = cnt
            cnt += 1
    win = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, NEG_INF, 0.0).astype(np.float32)


def _swin_block(x: Tensor, block: _SwinBlock, H: int, W: int, heads: int, ws: int,
                shift: int) -> Tensor:
    B, N, C = x.shape
    Dh = C // heads
    M = ws * ws

    h = block.norm1(x).reshape(B, H, W, C)
    if shift > 0:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
    windows = _window_partition(h, ws)                          # [B·nW, ws², C]
    nW = windows.shape[0]
    q, k, v = (t.reshape(nW, M, heads, Dh) for t in block.attn.qkv(windows).split(C, dim=-1))
    logits = (torch.einsum("wnhd,wmhd->whnm", q, k) * Dh ** -0.5).float()

    idx = torch.from_numpy(_rel_position_index(ws).reshape(-1)).to(x.device)
    bias = block.attn.relative_position_bias_table[idx].reshape(M, M, heads).permute(2, 0, 1)
    logits = logits + bias[None].float()
    if shift > 0:
        mask = torch.from_numpy(_shift_mask(H, W, ws, shift)).to(x.device)  # [nW_img, M, M]
        logits = (logits.reshape(B, mask.shape[0], heads, M, M)
                  + mask[None, :, None]).reshape(nW, heads, M, M)

    weights = torch.softmax(logits, dim=-1).to(x.dtype)
    attn = torch.einsum("whnm,wmhd->wnhd", weights, v).reshape(nW, M, C)
    attn = _window_reverse(block.attn.proj(attn), ws, H, W)
    if shift > 0:
        attn = torch.roll(attn, (shift, shift), dims=(1, 2))
    x = x + attn.reshape(B, N, C)
    h = block.mlp.fc2(F.gelu(block.mlp.fc1(block.norm2(x))))   # exact GELU
    return x + h


def _patch_merge(x: Tensor, stage: _Stage, H: int, W: int) -> Tensor:
    """Swin PatchMerging: 2×2 neighbours → LN → linear 4C→2C (bias-free)."""
    B, N, C = x.shape
    x = x.reshape(B, H, W, C)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                  dim=-1).reshape(B, N // 4, 4 * C)
    return stage.downsample.reduction(stage.downsample.norm(x))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5 (the kernel of ``jax.image.resize``'s
    ``bicubic``; PyTorch's bicubic uses a = -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


@lru_cache(maxsize=16)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """The [n_in, n_out] weights of ``jax.image.resize(..., "bicubic")``
    along one axis (``scale_and_translate``'s ``compute_weight_mat``, in
    float32 as it computes them): the kernel widened by the scale when
    downsampling (antialias), each output's weights renormalised to sum to
    one, none for a sample outside the input."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def reshape_wav2img(x: Tensor, cfg: HTSATConfig) -> Tensor:
    """Fold the mel spectrogram [B, C, T, F] into a square image
    [B, C, freq_ratio·F', T'/freq_ratio] (HTS-AT time/freq folding), after
    the JAX package's bicubic resize to (spec·ratio, spec/ratio): one
    product per axis whose size changes."""
    B, C, T, Fq = x.shape
    target_T = cfg.spec_size * cfg.freq_ratio
    target_F = cfg.spec_size // cfg.freq_ratio
    if T != target_T:
        w = torch.from_numpy(resize_weights(T, target_T)).to(x.device)
        x = (x.transpose(-1, -2) @ w).transpose(-1, -2)
    if Fq != target_F:
        x = x @ torch.from_numpy(resize_weights(Fq, target_F)).to(x.device)
    T, Fq = target_T, target_F
    x = x.transpose(2, 3).reshape(B, C, Fq, cfg.freq_ratio, T // cfg.freq_ratio)
    return x.permute(0, 1, 3, 2, 4).reshape(B, C, cfg.freq_ratio * Fq, T // cfg.freq_ratio)


def _patchify(img: Tensor, ph: int, pw: int) -> Tensor:
    """[B, H, W, C] → [B, H//ph, W//pw, C·ph·pw], flattened in the conv
    weight's (C, ph, pw) order."""
    B, H, W, C = img.shape
    gh, gw = H // ph, W // pw
    patches = img[:, :gh * ph, :gw * pw].reshape(B, gh, ph, gw, pw, C)
    return patches.permute(0, 1, 3, 5, 2, 4).reshape(B, gh, gw, C * ph * pw)


def _swin_trunk(branch: HTSAT, x: Tensor, H: int, W: int) -> Tensor:
    """Patch tokens [B, H·W, D] → pooled latent [B, latent_dim]."""
    cfg = branch.config
    for s, stage in enumerate(branch.layers):
        cur_ws = min(cfg.window_size, H)  # window == resolution → no shift possible
        for j, block in enumerate(stage.blocks):
            shift = 0 if (j % 2 == 0 or cur_ws == H) else cur_ws // 2
            x = _swin_block(x, block, H, W, cfg.heads[s], cur_ws, shift)
        if hasattr(stage, "downsample"):
            x = _patch_merge(x, stage, H, W)
            H //= 2
            W //= 2
    return branch.norm(x).mean(dim=1)  # token mean-pool = avgpool of the feature map


def htsat_latent(branch: HTSAT, mel: Tensor, *, dtype=torch.float32) -> Tensor:
    """log-mel [B, T, F] → pooled latent [B, latent_dim]."""
    x = branch.bn0(mel.float()[:, None])                       # B,1,T,F; bn0 over mel bins
    x = reshape_wav2img(x, branch.config).to(dtype)            # B,1,S,S
    p = branch.config.patch_size
    patches = _patchify(x.permute(0, 2, 3, 1), p, p)           # B,gh,gw,p·p
    B, gh, gw, _ = patches.shape
    x = _conv_linear(patches.reshape(B, gh * gw, -1), branch.patch_embed.proj)
    return _swin_trunk(branch, branch.patch_embed.norm(x), gh, gw)


def _aff_branch(x: Tensor, att: nn.ModuleDict, keys) -> Tensor:
    c1, b1, c2, b2 = (att[k] for k in keys)
    h = torch.relu(b1(_conv_linear(x, c1)))
    return b2(_conv_linear(h, c2))


def aff_fuse(fusion: _AFF, x: Tensor, residual: Tensor) -> Tensor:
    """AFF forward (channel-last [..., H, W, C]): MS-CAM attention over the
    sum, then a soft swap ``2·x·w + 2·residual·(1 - w)``."""
    xa = x + residual
    xl = _aff_branch(xa, fusion.local_att, ("0", "1", "3", "4"))
    xg = _aff_branch(xa.mean(dim=(-3, -2), keepdim=True), fusion.global_att,
                     ("1", "2", "4", "5"))
    wei = torch.sigmoid(xl + xg)
    return 2.0 * x * wei + 2.0 * residual * (1.0 - wei)


def htsat_latent_fusion(branch: HTSAT, mel_fusion: Tensor, *, dtype=torch.float32) -> Tensor:
    """The fusion forward: ``mel_fusion`` [B, 4, T, F] (channel 0 the whole
    clip's mel shrunk to 10 s, channels 1-3 three 10 s chunks) → pooled
    latent.  Rows whose chunks equal channel 0 (≤ 10 s audio) bypass AFF,
    laion_clap's per-sample ``longer`` gating.  Global channel → the patch
    conv; local chunks → ``mel_conv2d`` (kernel (p, 3p)), the chunks side
    by side, padded or cut to the global grid's width; merged by AFF."""
    B = mel_fusion.shape[0]
    longer = (mel_fusion[:, 1] != mel_fusion[:, 0]).flatten(1).any(dim=1)

    x = reshape_wav2img(branch.bn0(mel_fusion.float()), branch.config).to(dtype)
    p = branch.config.patch_size
    pe = branch.patch_embed
    g = _conv_linear(_patchify(x[:, 0:1].permute(0, 2, 3, 1), p, p), pe.proj)  # B,gh,gw,D
    gh, gw = g.shape[1:3]

    loc = x[:, 1:].reshape(B * 3, x.shape[2], x.shape[3])[..., None]
    loc = _conv_linear(_patchify(loc, p, 3 * p), pe.mel_conv2d)   # B·3,gh,gl,D
    gl, D = loc.shape[2], loc.shape[3]
    loc = loc.reshape(B, 3, gh, gl, D).permute(0, 2, 1, 3, 4).reshape(B, gh, 3 * gl, D)
    if 3 * gl >= gw:
        loc = loc[:, :, :gw]
    else:
        loc = F.pad(loc, (0, 0, 0, gw - 3 * gl))

    fused = aff_fuse(pe.fusion_model, g, loc)
    g = torch.where(longer[:, None, None, None], fused, g)
    tokens = pe.norm(g.reshape(B, gh * gw, D))
    return _swin_trunk(branch, tokens, gh, gw)


def clap_audio_embedding(audio: CLAPAudio, waveform: Tensor, *,
                         dtype=torch.float32) -> Tensor:
    """waveform [B, samples] at 48 kHz → CLAP joint-space embedding [B, 512]
    (``CLAP_Module.get_audio_embedding_from_data``): the int16 round trip,
    the 10 s crop or pad, log-mel, HTSAT, the audio projection."""
    # laion_clap's int16 trick, kept in float: truncation toward zero like
    # the int16 cast.
    x = torch.trunc(waveform.float().clamp(-1.0, 1.0) * 32767.0) / 32767.0
    T = x.shape[1]
    if T < CLAP_CLIP_SAMPLES:
        x = F.pad(x, (0, CLAP_CLIP_SAMPLES - T))
    elif T > CLAP_CLIP_SAMPLES:
        x = x[:, :CLAP_CLIP_SAMPLES]
    latent = htsat_latent(audio.audio_branch, log_mel_spectrogram(x), dtype=dtype)
    return _mlp2_apply(audio.audio_projection, latent)


def clap_audio_embedding_fusion(audio: CLAPAudio, mel_fusion: Tensor, *,
                                dtype=torch.float32) -> Tensor:
    """mel_fusion [B, 4, frames, 64] (host-built, ``ops.audio.build_mel_fusion``)
    → CLAP joint-space embedding [B, 512]."""
    latent = htsat_latent_fusion(audio.audio_branch, mel_fusion, dtype=dtype)
    return _mlp2_apply(audio.audio_projection, latent)


def clap_text_embedding(text: CLAPText, input_ids: Tensor,
                        attention_mask: Optional[Tensor] = None, *,
                        dtype=torch.float32) -> Tensor:
    """RoBERTa pooler_output → text projection MLP → [B, embed]
    (unnormalised, laion_clap's ``get_text_embedding`` before
    ``F.normalize``)."""
    _, pooled = roberta_apply(text.text_branch, input_ids, attention_mask, dtype=dtype)
    return _mlp2_apply(text.text_projection, pooled)


# ---------------------------------------------------------------------------
# Weights: a laion_clap checkpoint, else a seed
# ---------------------------------------------------------------------------


def _load_keys(module: nn.Module, sd) -> nn.Module:
    """Load the module's own keys from ``sd`` (a checkpoint holds more:
    buffers, heads and the other tower)."""
    module.load_state_dict({k: sd[k].float() for k in module.state_dict()})
    return module


def htsat_from_laion_clap(state_dict, cfg: HTSATConfig) -> CLAPAudio:
    """The audio half of a laion_clap checkpoint (keys with or without the
    ``module.`` prefix); ``mel_conv2d`` / ``fusion_model`` keys make it the
    fusion variant."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in state_dict.items()}
    fusion = any("fusion_model" in k or "mel_conv2d" in k for k in sd)
    return _load_keys(CLAPAudio(dataclasses.replace(cfg, enable_fusion=fusion)), sd)


def clap_text_from_laion_clap(state_dict) -> Optional[Tuple[CLAPText, RobertaConfig]]:
    """The text half of a laion_clap checkpoint (``text_branch.*`` RoBERTa +
    ``text_projection.{0,2}.*``), or ``None`` if it has none."""
    sd = {k.replace("module.", "", 1): v for k, v in state_dict.items()}
    sd = {k.replace("model.", "", 1) if k.startswith("model.") else k: v
          for k, v in sd.items()}
    if not any(k.startswith("text_branch.") for k in sd):
        return None
    emb = sd["text_branch.embeddings.word_embeddings.weight"]
    n_layers = max(int(k.split(".")[3]) for k in sd
                   if k.startswith("text_branch.encoder.layer.")) + 1
    hidden = emb.shape[1]
    cfg = RobertaConfig(
        vocab_size=emb.shape[0], hidden_size=hidden, num_layers=n_layers,
        num_heads=12 if hidden % 12 == 0 else 8,
        intermediate_size=sd["text_branch.encoder.layer.0.intermediate.dense.weight"].shape[0],
        max_position_embeddings=sd["text_branch.embeddings.position_embeddings.weight"].shape[0])
    embed_dim = sd["text_projection.0.weight"].shape[0]
    return _load_keys(CLAPText(cfg, embed_dim), sd), cfg


def load_clap(variant: str = "HTSAT-tiny", checkpoint_path: Optional[str] = None,
              device="cpu"):
    """CLAP weights from ``checkpoint_path`` or ``$CLIPCAP_CLAP_CHECKPOINT``
    (a laion_clap checkpoint), else seeded random weights with a warning.

    Returns ``(audio, audio_config, (text, RobertaConfig))``: the text tower
    reranks; a checkpoint without one gets the seeded tiny tower.
    """
    from clipcap_tpu_torch.convert import clap_text_from_params, htsat_from_params

    cfg = get_htsat_config(variant)

    def seeded_text():
        tree, rcfg = init_clap_text(cfg.embedding_dim)
        return clap_text_from_params(tree, rcfg).to(device), rcfg

    if cfg.name != "test-tiny":
        for path in (checkpoint_path, os.environ.get("CLIPCAP_CLAP_CHECKPOINT")):
            if path and os.path.exists(path):
                ckpt = torch.load(path, map_location="cpu", weights_only=False)
                sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
                audio = htsat_from_laion_clap(sd, cfg)
                text = clap_text_from_laion_clap(sd)
                text = seeded_text() if text is None else (text[0].to(device), text[1])
                return audio.to(device), audio.config, text
        warnings.warn(
            f"No CLAP checkpoint found for '{variant}' (set CLIPCAP_CLAP_CHECKPOINT). "
            "Using RANDOM weights — fine for smoke tests, wrong for real audio captioning.")
    return htsat_from_params(init_htsat(cfg), cfg).to(device), cfg, seeded_text()
