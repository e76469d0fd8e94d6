"""The assembled ClipCap model: mapping network + GPT-2 decoder.

Counterpart of ``clipcap_tpu/models/clipcap.py``.  :class:`ClipCapModel`
holds the reference's two submodules, ``language_model`` and
``transformer_mapper``, so its state dict carries the reference's key
prefixes; :func:`load` reads the JAX package's ``.npz`` + YAML checkpoints;
:func:`clipcap_loss` is the training loss.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from clipcap_tpu_torch.config import Config
from clipcap_tpu_torch.models.gpt2 import (GPT2, GPT2Config, get_gpt2_config, gpt2_apply,
                                           gpt2_embed_tokens, init_gpt2, lm_logits)
from clipcap_tpu_torch.models.mapper import (MapperConfig, TransformerMapper, init_mapper,
                                             mapper_apply)
from clipcap_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor


class ClipCapModel(nn.Module):
    """``language_model`` (GPT-2) + ``transformer_mapper``;
    ``model.transformer_mapper(embeddings)`` maps encoder embeddings to the
    LM prefix, as in the reference's demo."""

    def __init__(self, config: Config, language_model: GPT2,
                 transformer_mapper: TransformerMapper):
        super().__init__()
        self.config = config
        self.language_model = language_model
        self.transformer_mapper = transformer_mapper

    @property
    def lm_config(self) -> GPT2Config:
        return self.language_model.config

    @property
    def mapper_config(self) -> MapperConfig:
        return self.transformer_mapper.config

    @property
    def prefix_length(self) -> int:
        return self.config.prefix_length

    @property
    def device(self) -> torch.device:
        return self.language_model.wte.weight.device

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


def init_clipcap(config: Config, lm_config: Optional[GPT2Config] = None,
                 seed: int = 0) -> ClipCapModel:
    """A ClipCap model as the JAX package's ``init_clipcap`` builds it: the
    mapper from ``init_mapper(seed)``; GPT-2 from ``init_gpt2(lm_config,
    seed)`` when ``lm_config`` is given, else resolved by name
    (``hf_import.load_gpt2``: HF weights on disk, or seeded with a
    warning; never fetched)."""
    from clipcap_tpu_torch.convert import gpt2_from_params, mapper_from_params
    from clipcap_tpu_torch.models.hf_import import load_gpt2

    if lm_config is None:
        lm = load_gpt2(config.language_model)
    else:
        lm = gpt2_from_params(init_gpt2(lm_config, seed=seed), lm_config)
    mapper_config = build_mapper_config(config, lm.config.n_embd)
    return ClipCapModel(config, lm,
                        mapper_from_params(init_mapper(mapper_config, seed=seed), mapper_config))


def load(model_path: str, config_path: str, device="cuda",
         from_checkpoint: bool = False) -> Tuple[ClipCapModel, Any]:
    """Load a model (``.npz`` written by either package) and its YAML config
    onto ``device``, plus the tokenizer.  ``device="cuda"`` raises when
    CUDA is absent."""
    from clipcap_tpu_torch.config import load_yaml_config
    from clipcap_tpu.utils.tokenizer import get_tokenizer
    from clipcap_tpu_torch.train.checkpoint import restore_params

    dev = resolve_device(device)
    config = load_yaml_config(config_path)
    if from_checkpoint:
        config.training_config = None
    model = model_from_params(config, restore_params(model_path))
    return model.to(dev), get_tokenizer(config.language_model)


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
