"""clipcap_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of clipcap_tpu.

The same public API as ``clipcap_tpu`` (and the reference ``clipcap``
package), run eagerly by PyTorch with hand-written CUDA kernels where the
JAX package used Pallas:

    import clipcap_tpu_torch as clipcap
    model, tokenizer = clipcap.load("model.npz", "config.yaml", device="cuda")
    encoder, transform = clipcap.get_encoder_from_model(model, device="cuda")
    embedding = encoder(transform("image.jpg")[None])
    prefix = model.transformer_mapper(embedding)
    captions = clipcap.generate_beam(model, tokenizer, prefix)

The package imports ``torch`` and never ``jax``, and nothing of
``clipcap_tpu``: it keeps its own copies of the JAX-free modules it needs
(config, tokenizers, CLI argument types, the dataset reader and writer).
Imports are lazy so ``import clipcap_tpu_torch`` stays cheap and builds no
kernel.
"""
from __future__ import annotations

__version__ = "0.1.0"

__all__ = [
    "load",
    "get_encoder_from_model",
    "get_encoder",
    "get_encoder_from_config",
    "generate",
    "generate_beam",
    "generate_no_beam",
    "generate_nucleus_sampling",
]


def __getattr__(name):
    if name == "load":
        from clipcap_tpu_torch.models.clipcap import load

        return load
    if name in ("get_encoder", "get_encoder_from_config", "get_encoder_from_model"):
        from clipcap_tpu_torch.encoders import base

        return getattr(base, name)
    if name in ("generate", "generate_beam", "generate_no_beam",
                "generate_nucleus_sampling"):
        from clipcap_tpu_torch.inference import generate as gen_mod

        return getattr(gen_mod, name)
    raise AttributeError(f"module 'clipcap_tpu_torch' has no attribute '{name}'")
