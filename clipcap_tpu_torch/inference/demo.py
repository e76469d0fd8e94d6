"""Inference demo CLI — ``python -m clipcap_tpu_torch.inference``.

Counterpart of ``clipcap_tpu/inference/demo.py``: load the model and its
encoder, embed one image, nucleus-sample N captions, rerank them by the
encoder's image↔text similarity, print every candidate and the best.
"""
from __future__ import annotations

from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser, Namespace

import numpy as np

from clipcap_tpu_torch.encoders.base import get_encoder_from_model
from clipcap_tpu_torch.inference.args import add_inference_args
from clipcap_tpu_torch.inference.generate import generate_nucleus_sampling
from clipcap_tpu_torch.models.clipcap import load


def inference_demo(args: Namespace) -> int:
    model, tokenizer = load(args.model_path, args.config_path, device=args.device,
                            from_checkpoint=args.is_checkpoint)
    text_prefix_tokens = None
    if args.text_prefix is not None:
        text_prefix_tokens = np.asarray(tokenizer.encode(args.text_prefix), np.int64)[None, :]

    encode_method, sample_processor = get_encoder_from_model(model, device=args.device)
    sample = sample_processor(args.sample_path)
    media_features = encode_method(sample[None])          # [1, E] or [1, W, E]
    prefix = model.transformer_mapper(media_features)
    captions = generate_nucleus_sampling(
        model, tokenizer, prefix, number_to_generate=args.number_to_generate,
        text_prefix_tokens=text_prefix_tokens, top_p=args.top_p, top_k=args.top_k,
        temperature=args.temperature, seed=args.seed, int8_kv=args.int8_kv_cache)

    similarities = encode_method.similarity(sample, captions)
    for caption, similarity in zip(captions, similarities.tolist()):
        print("sim", similarity, "caption", caption)
    print("mean sim", float(np.mean(similarities)))
    print("best", captions[int(np.argmax(similarities))])
    return 0


def run_inference_demo() -> int:
    parser = ArgumentParser(description=__doc__, formatter_class=ArgumentDefaultsHelpFormatter)
    return inference_demo(add_inference_args(parser).parse_args())


if __name__ == "__main__":
    exit(run_inference_demo())
