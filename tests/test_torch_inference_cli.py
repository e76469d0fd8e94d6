"""The inference CLI's inputs in both packages: reference torch state dicts
through ``load``, and the parser's flags.

A state dict in the original ClipCap's key layout (``transformer_mapper.*``
with ``nn.Linear`` weights, ``language_model.*`` in HF GPT-2 names) is
written with ``torch.save`` from seeded weights, bare (``.pt``), wrapped
as a Lightning checkpoint (``.ckpt``) or mapper-only.  Both packages load
it: the parameters must be equal, and top_k = 1 captions equal token for
token (fp32).
"""
import contextlib
import io
from argparse import ArgumentParser

import numpy as np
import pytest
import torch

from clipcap_tpu.config import Config, EncoderConfig, save_yaml_config
from clipcap_tpu.inference import generate as jgen
from clipcap_tpu.inference.args import add_inference_args as jadd_inference_args
from clipcap_tpu.models import clipcap as jclipcap
from clipcap_tpu.models.gpt2 import GPT2_PRESETS, init_gpt2
from clipcap_tpu_torch.convert import (GPT2_RULES, MAPPER_RULES, state_dict_from_tree)
from clipcap_tpu_torch.inference import generate as tgen
from clipcap_tpu_torch.inference.args import add_inference_args
from clipcap_tpu_torch.models import clipcap as tclipcap

torch.set_num_threads(1)
SEED = 3


def _reference_state_dict(params, cfg) -> dict:
    """The original ClipCap model's state dict of ``params`` (the JAX tree)."""
    mapper = state_dict_from_tree(params["mapper"], [(MAPPER_RULES, cfg.transformer_layers)])
    lm_cfg = GPT2_PRESETS[cfg.language_model]
    lm = state_dict_from_tree(params["lm"], [(GPT2_RULES, lm_cfg.n_layer)])
    sd = {f"transformer_mapper.{k}": v for k, v in mapper.items()}
    sd.update({f"language_model.transformer.{k}": v for k, v in lm.items()})
    sd["language_model.lm_head.weight"] = lm["wte.weight"]
    for i in range(lm_cfg.n_layer):          # older HF GPT-2 keeps the causal mask as a buffer
        sd[f"language_model.transformer.h.{i}.attn.bias"] = torch.ones(
            1, 1, lm_cfg.n_positions, lm_cfg.n_positions).tril()
    return sd


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("reference_ckpt")
    config = Config(language_model="gpt2-test", prefix_length=4, projection_length=4,
                    transformer_layers=2, transformer_attention_heads=2,
                    encoder_config=EncoderConfig(encoder_model_variant="test-tiny",
                                                 encoder_embedding_size=32))
    params = jclipcap.init_clipcap(config, lm_config=GPT2_PRESETS["gpt2-test"],
                                   seed=SEED).params
    sd = _reference_state_dict(params, config)
    torch.save(sd, d / "model.pt")
    torch.save({"epoch": 3, "global_step": 120, "state_dict": sd}, d / "model.ckpt")
    torch.save({k[len("transformer_mapper."):]: v for k, v in sd.items()
                if k.startswith("transformer_mapper.")}, d / "mapper.pt")
    save_yaml_config(config, str(d / "config.yaml"))
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    Image.fromarray(img).save(d / "image.png")
    return d, params


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name,from_checkpoint", [("model.pt", False), ("model.ckpt", True),
                                                  ("mapper.pt", False)])
def test_reference_state_dict_loads_alike_in_both_packages(reference, name, from_checkpoint):
    d, params = reference
    args = (str(d / name), str(d / "config.yaml"))
    jmodel, tok = jclipcap.load(*args, from_checkpoint=from_checkpoint)
    tmodel, _ = tclipcap.load(*args, device="cpu", from_checkpoint=from_checkpoint)
    got = tmodel.params()
    _assert_trees_equal(got["mapper"], params["mapper"])
    _assert_trees_equal(got["mapper"], jmodel.params["mapper"])
    _assert_trees_equal(got["lm"], jmodel.params["lm"])
    # A mapper-only dict leaves the LM to its name: gpt2-test's seed-0 draws.
    want_lm = init_gpt2(GPT2_PRESETS["gpt2-test"]) if name == "mapper.pt" else params["lm"]
    _assert_trees_equal(got["lm"], want_lm)

    emb = np.random.default_rng(1).standard_normal((1, 32)).astype(np.float32)
    prefix = tmodel.transformer_mapper(emb).detach().numpy()
    np.testing.assert_allclose(prefix, np.asarray(jmodel.transformer_mapper(emb)),
                               atol=1e-4, rtol=1e-4)
    kw = dict(number_to_generate=2, top_k=1, entry_length=20)
    want = jgen.generate_nucleus_sampling(jmodel, tok, prefix, **kw)
    got = tgen.generate_nucleus_sampling(tmodel, tok, prefix, **kw)
    assert got == want and len(got) == 2


def test_unported_checkpoint_formats_raise(reference, tmp_path):
    d, _ = reference
    for path in (str(tmp_path / "model.msgpack"), str(tmp_path)):     # msgpack, orbax dir
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tclipcap.load(path, str(d / "config.yaml"), device="cpu")


def _flags(parser: ArgumentParser) -> dict:
    return {s: a.default for a in parser._actions for s in a.option_strings
            if s.startswith("--") and s != "--help"}


# Absent from the port on purpose: the serving mesh (ROADMAP A9).
NOT_PORTED = {"--mesh-data", "--mesh-model"}


def test_inference_flags_match_the_jax_parser():
    jflags = _flags(jadd_inference_args(ArgumentParser()))
    tflags = _flags(add_inference_args(ArgumentParser()))
    assert set(jflags) - set(tflags) == NOT_PORTED
    assert set(tflags) <= set(jflags)
    # Same defaults, but the device: the JAX CLI's "tpu", the port's "cuda".
    assert {f: v for f, v in tflags.items() if f != "--device"} == \
        {f: v for f, v in jflags.items() if f in tflags and f != "--device"}


def test_penalty_flags_parse_and_change_no_caption(reference):
    from clipcap_tpu_torch.inference.demo import inference_demo

    d, _ = reference
    argv = ["--model-path", str(d / "model.ckpt"), "--is-checkpoint", "true",
            "--config-path", str(d / "config.yaml"), "--sample-path", str(d / "image.png"),
            "--device", "cpu", "--number-to-generate", "2", "--top-k", "1"]
    outputs = []
    for extra in ([], ["--repetition-penalty", "2.5", "--desired-sentence-length", "7"]):
        args = add_inference_args(ArgumentParser()).parse_args(argv + extra)
        if extra:
            assert (args.repetition_penalty, args.desired_sentence_length) == (2.5, 7)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            assert inference_demo(args) == 0
        outputs.append(log.getvalue())
    assert "best" in outputs[0] and outputs[0] == outputs[1]
