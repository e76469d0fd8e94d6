"""The assembled ClipCap model: mapping network + GPT-2 decoder.

Counterpart of ``clipcap_tpu/models/clipcap.py``.  :class:`ClipCapModel`
holds the reference's two submodules, ``language_model`` and
``transformer_mapper``, so its state dict carries the reference's key
prefixes; :func:`load` reads the JAX package's ``.npz`` + YAML checkpoints
and the reference's torch state dicts;
:func:`clipcap_loss` is the training loss.

``language_model`` may also name a DeepSeek-V2 (``deepseek-ai/DeepSeek-V2-Lite``,
``models/deepseek_v2.py``; seeded with a warning without weights on disk),
a Kimi-Linear (``moonshotai/Kimi-Linear-48B-A3B-Instruct``,
``models/kimi_linear.py``: one chip's share of its experts, 32 of 256;
always seeded, with a warning) or a Granite-4.0-H
(``ibm-granite/granite-4.0-h-small``, ``models/granite_hybrid.py``: one
chip's share of its experts, 9 of 72; seeded with a warning without
weights on disk) or a LongCat-Flash (``meituan-longcat/LongCat-Flash-Chat``,
``models/longcat_flash.py``: one chip's share of its FFN experts, 8 of
512; seeded with a warning without weights on disk): :func:`init_clipcap`
builds it, with the mapper at its hidden width, and beam search serves
it; training with it raises ``NotImplementedError``.
"""
from __future__ import annotations

import os
from typing import Any, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from clipcap_tpu_torch.config import Config
from clipcap_tpu_torch.models.deepseek_v2 import (DeepseekV2, DeepseekV2Config, init_dsv2,
                                                  is_dsv2, load_dsv2)
from clipcap_tpu_torch.models.gpt2 import (GPT2, GPT2Config, get_gpt2_config, gpt2_apply,
                                           gpt2_embed_tokens, init_gpt2, lm_logits)
from clipcap_tpu_torch.models.granite_hybrid import (GraniteHybrid, GraniteHybridConfig,
                                                     init_granite, is_granite, load_granite)
from clipcap_tpu_torch.models.kimi_linear import (KimiLinear, KimiLinearConfig, init_kimi,
                                                  is_kimi, load_kimi)
from clipcap_tpu_torch.models.longcat_flash import (LongcatFlash, LongcatFlashConfig,
                                                    init_longcat, is_longcat, load_longcat)
from clipcap_tpu_torch.models.mapper import (MapperConfig, TransformerMapper, init_mapper,
                                             mapper_apply)
from clipcap_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


class ClipCapModel(nn.Module):
    """``language_model`` (GPT-2) + ``transformer_mapper``;
    ``model.transformer_mapper(embeddings)`` maps encoder embeddings to the
    LM prefix, as in the reference's demo."""

    def __init__(self, config: Config,
                 language_model: Union[GPT2, DeepseekV2, KimiLinear, GraniteHybrid,
                                       LongcatFlash],
                 transformer_mapper: TransformerMapper):
        super().__init__()
        self.config = config
        self.language_model = language_model
        self.transformer_mapper = transformer_mapper

    @property
    def lm_config(self) -> Union[GPT2Config, DeepseekV2Config, KimiLinearConfig,
                                 GraniteHybridConfig, LongcatFlashConfig]:
        return self.language_model.config

    @property
    def mapper_config(self) -> MapperConfig:
        return self.transformer_mapper.config

    @property
    def prefix_length(self) -> int:
        return self.config.prefix_length

    @property
    def device(self) -> torch.device:
        return next(self.language_model.parameters()).device

    def params(self) -> dict:
        """The JAX package's parameter tree ``{"mapper", "lm"}`` (numpy)."""
        from clipcap_tpu_torch.convert import gpt2_params, mapper_params

        return {"mapper": mapper_params(self.transformer_mapper),
                "lm": gpt2_params(self.language_model)}


def build_mapper_config(config: Config, lm_embedding_size: int) -> MapperConfig:
    """The reference's wiring: the windowed mapper gets ``window_size + 1``
    windows (global + tiles)."""
    enc = config.encoder_config
    window = None
    use_pos = False
    if enc is not None and enc.use_windowed_embeddings:
        window = enc.window_size + 1
        use_pos = config.use_positional_embeddings
    return MapperConfig(
        encoder_embedding_size=enc.encoder_embedding_size if enc else 512,
        lm_embedding_size=lm_embedding_size,
        prefix_length=config.prefix_length,
        projection_length=config.projection_length,
        num_heads=config.transformer_attention_heads,
        num_layers=config.transformer_layers,
        window_size=window,
        use_pos_embeddings=use_pos,
    )


def model_from_params(config: Config, params: dict,
                      lm_config: Optional[GPT2Config] = None) -> ClipCapModel:
    """A :class:`ClipCapModel` from the parameter tree ``{"mapper", "lm"}``."""
    from clipcap_tpu_torch.convert import gpt2_from_params, mapper_from_params

    lm_config = lm_config or get_gpt2_config(config.language_model)
    mapper_config = build_mapper_config(config, lm_config.n_embd)
    return ClipCapModel(config, gpt2_from_params(params["lm"], lm_config),
                        mapper_from_params(params["mapper"], mapper_config))


def init_clipcap(config: Config,
                 lm_config: Union[GPT2Config, DeepseekV2Config, KimiLinearConfig,
                                  GraniteHybridConfig, LongcatFlashConfig, None] = None,
                 seed: int = 0) -> ClipCapModel:
    """A ClipCap model as the JAX package's ``init_clipcap`` builds it: the
    mapper from ``init_mapper(seed)``; GPT-2 from ``init_gpt2(lm_config,
    seed)`` (a DeepSeek-V2 from ``init_dsv2``, a Kimi-Linear from
    ``init_kimi``, a Granite-4.0-H from ``init_granite``, a LongCat-Flash
    from ``init_longcat``) when ``lm_config`` is given, else resolved by
    name (``hf_import.load_gpt2``, ``deepseek_v2.load_dsv2``,
    ``kimi_linear.load_kimi``, ``granite_hybrid.load_granite`` or
    ``longcat_flash.load_longcat``: HF weights on disk, or seeded with a
    warning; never fetched)."""
    from clipcap_tpu_torch.convert import gpt2_from_params, mapper_from_params
    from clipcap_tpu_torch.models.hf_import import load_gpt2

    if lm_config is None:
        name = config.language_model
        lm = (load_dsv2(name) if is_dsv2(name) else load_kimi(name) if is_kimi(name)
              else load_granite(name) if is_granite(name)
              else load_longcat(name) if is_longcat(name) else load_gpt2(name))
    elif isinstance(lm_config, DeepseekV2Config):
        lm = init_dsv2(lm_config, seed=seed)
    elif isinstance(lm_config, KimiLinearConfig):
        lm = init_kimi(lm_config, seed=seed)
    elif isinstance(lm_config, GraniteHybridConfig):
        lm = init_granite(lm_config, seed=seed)
    elif isinstance(lm_config, LongcatFlashConfig):
        lm = init_longcat(lm_config, seed=seed)
    else:
        lm = gpt2_from_params(init_gpt2(lm_config, seed=seed), lm_config)
    mapper_config = build_mapper_config(config, lm.config.n_embd)
    return ClipCapModel(config, lm,
                        mapper_from_params(init_mapper(mapper_config, seed=seed), mapper_config))


def load(model_path: str, config_path: str, device="cuda",
         from_checkpoint: bool = False) -> Tuple[ClipCapModel, Any]:
    """Load a model and its YAML config onto ``device``, plus the tokenizer,
    as the JAX package's ``load``: an ``.npz`` written by either package,
    or a reference PyTorch state dict (``.pt``, ``.ckpt``, ``.bin``,
    ``.safetensors``) converted on the fly, so that mappers trained by the
    original ClipCap can be served.  ``device="cuda"`` raises when CUDA is
    absent."""
    from clipcap_tpu_torch.config import load_yaml_config
    from clipcap_tpu_torch.utils.tokenizer import get_tokenizer

    dev = resolve_device(device)
    config = load_yaml_config(config_path)
    if from_checkpoint:
        config.training_config = None
    if model_path.endswith(".npz"):
        from clipcap_tpu_torch.train.checkpoint import restore_params

        model = model_from_params(config, restore_params(model_path))
    elif model_path.endswith(".msgpack") or os.path.isdir(model_path):
        raise NotImplementedError(f"{model_path}: msgpack and orbax checkpoints are not "
                                  "ported (ROADMAP.md, queue A); use an .npz or a torch "
                                  "state dict")
    else:
        model = _model_from_torch(config, model_path, from_checkpoint)
    return model.to(dev), get_tokenizer(config.language_model)


def _model_from_torch(config: Config, path: str, from_checkpoint: bool) -> ClipCapModel:
    """The reference's state dict (``transformer_mapper.*`` and, when
    present, ``language_model.*`` in HF GPT-2 names; or a mapper-only
    dict).  Without LM keys the LM is resolved by name, as ``init_clipcap``
    does."""
    from clipcap_tpu_torch.models.hf_import import gpt2_from_hf, load_gpt2, load_torch_state_dict
    from clipcap_tpu_torch.models.mapper import mapper_from_torch

    sd = load_torch_state_dict(path)
    if from_checkpoint and "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    lm = load_gpt2(config.language_model)
    lm_sd = {k[len("language_model."):]: v for k, v in sd.items()
             if k.startswith("language_model.")}
    if lm_sd:
        lm = gpt2_from_hf(lm_sd, lm.config)
    mapper = mapper_from_torch(sd, build_mapper_config(config, lm.config.n_embd))
    return ClipCapModel(config, lm, mapper)


# ---------------------------------------------------------------------------
# Forward + loss (the JAX package's ``clipcap_forward`` / ``clipcap_loss``)
# ---------------------------------------------------------------------------

# Positions per cross-entropy chunk: the [B, T, V] fp32 logits are never
# held at once, and each chunk's logits are recomputed in the backward pass.
CE_CHUNK = 16


def clipcap_forward(model: ClipCapModel, tokens: Tensor, embeddings, mask: Tensor, *,
                    dtype=torch.float32, remat: bool = False) -> Tensor:
    """Prefix embeddings + token embeddings through GPT-2 → the final
    hidden states ``[B, prefix+T, D]``, which the loss projects onto the
    vocabulary in chunks (``lm_logits``).  ``tokens`` [B, T] must be valid
    ids (pads replaced); ``mask`` [B, T] marks the real tokens."""
    if not isinstance(model.language_model, GPT2):
        lm = model.language_model
        raise NotImplementedError(f"training with a {type(lm).__name__} language model is not "
                                  f"ported (ROADMAP.md, {lm.roadmap_item})")
    token_embeddings = gpt2_embed_tokens(model.language_model, tokens, dtype)
    prefix = mapper_apply(model.transformer_mapper, embeddings, dtype=dtype)
    inputs_embeds = torch.cat([prefix, token_embeddings], dim=1)
    prefix_mask = torch.ones(prefix.shape[:2], dtype=torch.bool, device=prefix.device)
    full_mask = torch.cat([prefix_mask, mask.bool()], dim=1)
    out, _ = gpt2_apply(model.language_model, inputs_embeds=inputs_embeds,
                        attention_mask=full_mask, dtype=dtype, remat=remat,
                        return_logits=False)
    return out


def _chunk_nll(lm: GPT2, h: Tensor, t: Tensor, m: Tensor) -> Tensor:
    logp = torch.log_softmax(lm_logits(lm, h).float(), dim=-1)
    return -(logp.gather(-1, t[..., None])[..., 0] * m.float()).sum()


def clipcap_loss(model: ClipCapModel, tokens: Tensor, embeddings, *,
                 dtype=torch.float32, remat: bool = False) -> Tensor:
    """Mean cross-entropy over the caption tokens (``tokens`` [B, T], -1
    pads).  Token t is predicted from position ``prefix_length-1+t``; the
    mask is the pads' positions, so token id 0 ("!") counts.  The sum over
    valid tokens is divided by ``max(count, 1)``.

    Gradients reach the parameters that require them: prefix-only
    training (the JAX package's ``freeze_lm``) is GPT-2 with
    ``requires_grad`` off (``train.state.create_train_state``).
    """
    P = model.prefix_length
    mask = tokens >= 0
    safe_tokens = torch.where(mask, tokens, 0)
    hidden = clipcap_forward(model, safe_tokens, embeddings, mask, dtype=dtype, remat=remat)
    T = tokens.shape[1]
    pred_h = hidden[:, P - 1:P - 1 + T]
    nll = torch.zeros((), dtype=torch.float32, device=pred_h.device)
    for t0 in range(0, T, CE_CHUNK):
        nll = nll + checkpoint(_chunk_nll, model.language_model, pred_h[:, t0:t0 + CE_CHUNK],
                               safe_tokens[:, t0:t0 + CE_CHUNK], mask[:, t0:t0 + CE_CHUNK],
                               use_reentrant=False)
    return nll / mask.sum().float().clamp_min(1.0)
