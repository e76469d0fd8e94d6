"""Eval driver — ``python -m clipcap_tpu_torch.eval``.

Counterpart of ``clipcap_tpu/eval/base.py``: the generation loop the
reference ships disabled, batched — encoder forward → mapper prefix →
nucleus sampling → encoder-similarity rerank, ``--eval-batch-size``
samples per device batch (padded to a fixed shape) — then the CSV join and
the native metric harness (BLEU/METEOR/ROUGE-L/CIDEr/SPICE/SPIDEr, no
Java).  ``--predictions-json`` scores precomputed predictions instead.

The sampler is a ``torch.Generator`` on the model's device seeded from
``--seed`` at each batch (the JAX package reuses one PRNG key per batch), so
sampled captions differ from the JAX package's except where the choice is
deterministic (``--top-k 1``).  ``--device`` defaults to ``cuda``; the CPU
is taken only when asked for.  The decode cache's layout and the decode
kernel's form follow ``CLIPCAP_CACHE_TILE_MAJOR`` and
``CLIPCAP_FLASH_MANUAL`` (``SamplingParams.tile_major`` left to its env
default, as in the JAX package).
"""
from __future__ import annotations

import json
import sys
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser, Namespace
from pprint import pprint
from typing import Optional, Sequence

import numpy as np
import torch

from clipcap_tpu_torch.encoders.base import get_encoder_from_model
from clipcap_tpu_torch.eval.args import add_eval_args
from clipcap_tpu_torch.eval.dataset import EvalDataset
from clipcap_tpu_torch.eval.metrics import evaluate_metrics_from_lists
from clipcap_tpu_torch.inference.args import add_inference_args
from clipcap_tpu_torch.models.clipcap import load
from clipcap_tpu_torch.ops.quant import quantize_gpt2_int8
from clipcap_tpu_torch.utils.braceexpand import braceexpand


def prepare_model(args: Namespace):
    model, tokenizer = load(args.model_path, args.config_path, device=args.device,
                            from_checkpoint=args.is_checkpoint)
    from clipcap_tpu_torch.utils.tokenizer import ByteTokenizer

    if isinstance(tokenizer, ByteTokenizer) and not args.allow_fallback_tokenizer:
        raise RuntimeError(
            "eval needs the real GPT-2 tokenizer: only the byte-level fallback is "
            "available, so generated captions would not match a pretrained GPT-2 and every "
            "score would be meaningless. Set CLIPCAP_TOKENIZER_PATH to the GPT-2 vocab "
            "files, or pass --allow-fallback-tokenizer to proceed anyway (smoke tests only).")
    if args.int8_weights:
        model.language_model = quantize_gpt2_int8(model.language_model)
    encode_method, sample_processor = get_encoder_from_model(model, device=args.device)
    return model, tokenizer, encode_method, sample_processor


@torch.no_grad()
def generate_predictions(args: Namespace) -> dict:
    """Batched generation: ``eval_batch_size`` samples × ``number_to_generate``
    candidates per decode, then one text-tower pass for the rerank."""
    from clipcap_tpu_torch.inference.engine import SamplingParams, decode
    from clipcap_tpu_torch.inference.generate import _decode_texts

    model, tokenizer, encode_method, sample_processor = prepare_model(args)

    def safe_processor(path):
        """Warn and continue on undecodable files (the eval folder may hold
        caption .txt files next to media; the reference globs '*' too)."""
        try:
            return sample_processor(path)
        except Exception as e:
            print(f"warning: cannot decode '{path}' ({e}), skipping")
            return None

    n_gen = max(1, args.number_to_generate)
    eb = max(1, args.eval_batch_size)
    sp = SamplingParams(
        max_new_tokens=67, temperature=args.temperature,
        top_k=int(args.top_k) if args.top_k else 0,
        top_p=float(args.top_p) if args.top_p else 1.0,
        repetition_penalty=1.0, sentence_length_factor=0.0,
        stop_token=tokenizer.encode(".")[0], include_stop_token=True, mode="nucleus",
        int8_kv=args.int8_kv_cache)
    gen_dtype = torch.bfloat16 if args.fp_precision == 16 else torch.float32

    dataset = EvalDataset(safe_processor, args.sample_path)
    predictions = {}
    names, samples = [], []

    def flush():
        if not names:
            return
        batch = np.stack(samples)
        pad = eb - len(names)          # a fixed batch shape, as in the JAX package
        if pad:
            batch = np.concatenate([batch, np.repeat(batch[:1], pad, axis=0)])
        features = encode_method(batch)
        prefix = model.transformer_mapper(features)
        tiled = prefix.repeat_interleave(n_gen, dim=0)                 # [eb·n, P, D]
        generator = torch.Generator(device=model.device).manual_seed(args.seed)
        result = decode(model.language_model, tiled, generator, sp, dtype=gen_dtype)
        all_caps = [_decode_texts(tokenizer, [], type(result)(
            tokens=result.tokens[i * n_gen:(i + 1) * n_gen],
            lengths=result.lengths[i * n_gen:(i + 1) * n_gen])) for i in range(len(names))]

        # Batched rerank: one text-tower pass for every candidate, cosine
        # against the sample embeddings already computed (both of the port's
        # encoders, CLIP and CLAP, have a text tower).
        text = encode_method.encode_text([c for caps in all_caps for c in caps])
        feats = np.asarray(features, dtype=np.float32)
        if feats.ndim == 3:              # windowed embeddings: rerank on the global view
            feats = feats[:, 0]
        feats = feats / np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True), 1e-9)
        for i, name in enumerate(names):
            sims = feats[i] @ text[i * n_gen:(i + 1) * n_gen].T
            predictions[name] = all_caps[i][int(np.argmax(sims))]
        print(f"eval: {len(predictions)} of {len(dataset)} files captioned")
        names.clear()
        samples.clear()

    for filename, sample in dataset:
        if sample is None:
            continue
        names.append(filename)
        samples.append(np.asarray(sample))
        if len(names) == eb:
            flush()
    flush()
    return predictions


def eval(args: Namespace) -> int:
    if args.predictions_json:
        with open(args.predictions_json, "r") as f:
            predictions = json.load(f)
    else:
        predictions = generate_predictions(args)

    if args.save_predictions:
        with open(args.save_predictions, "w") as f:
            json.dump(predictions, f)

    import pandas as pd

    reference_df = pd.read_csv(args.reference_csv)
    predictions_list, references_list, ids = [], [], []
    for index, row in reference_df.iterrows():
        filename = row[args.csv_filename_column]
        if filename not in predictions:
            print(f"warning: no prediction for '{filename}', skipping")
            continue
        references = [row[key] for key in braceexpand(args.csv_reference_caption_columns)]
        references_list.append(references)
        predictions_list.append(predictions[filename])
        ids.append(index)

    scores, per_file = evaluate_metrics_from_lists(predictions_list, references_list, ids)

    if args.save_file is not None:
        with open(args.save_file, "w+") as f:
            json.dump(scores, f)
    pprint(scores)
    return 0


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__, formatter_class=ArgumentDefaultsHelpFormatter)
    return add_inference_args(add_eval_args(parser))


def run_eval(argv: Optional[Sequence[str]] = None) -> int:
    """The CLI: ``argv`` as the command line gives it (None: ``sys.argv``)."""
    return eval(build_parser().parse_args(sys.argv[1:] if argv is None else list(argv)))


if __name__ == "__main__":
    exit(run_eval())
