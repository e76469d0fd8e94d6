"""Int8 weights in the port (``clipcap_tpu_torch.ops.quant``) against the
JAX package's ``clipcap_tpu.ops.quant``.

Weights and inputs are made with numpy from a seed and fed to both
packages, fp32 unless said.  ``quantize_linear`` must give JAX's ``q``
and ``s`` bit for bit (``q`` transposed where the module's layout is
``[out, in]``), the w8a8 product agree within 1e-5 relative, int8-weight
GPT-2 logits within 1e-4 and its beam-5 tokens equal, and the w8a8 ViT
within 1e-4.  The JAX ViT runs its attention through XLA
(``CLIPCAP_FUSED_ATTN=0``), the plain form of its Pallas kernel, as its
own int8 tests run it.  The port's side is the CPU, where ``torch._int_mm``
and the kernels' twins run.
"""
import contextlib
import io
from argparse import ArgumentParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.config import Config, EncoderConfig, save_yaml_config
from clipcap_tpu.inference import generate as jgen
from clipcap_tpu.models import clip_vit as jclip
from clipcap_tpu.models import clipcap as jclipcap
from clipcap_tpu.models import gpt2 as jgpt2
from clipcap_tpu.ops import quant as jquant
from clipcap_tpu.train.checkpoint import save_params as jsave_params
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.inference import generate as tgen
from clipcap_tpu_torch.models import clip_vit, gpt2
from clipcap_tpu_torch.models import clipcap as tclipcap
from clipcap_tpu_torch.ops import quant
from clipcap_tpu_torch.ops.layers import Int8Weight

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tied_weight(rng, n_in, n_out):
    """[in, out] fp32 weights with one all-zero output channel and exact
    .5 quotients: column 1 has absmax 127/64, so s = 1/64 exactly and
    (k + 0.5)/64 rounds half to even."""
    w = rng.standard_normal((n_in, n_out)).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = np.array([127, 2.5, 3.5, -2.5, -3.5, 0.5, -0.5, 126.5] * (n_in // 8),
                       np.float32)[:n_in] / 64
    return w


@pytest.mark.parametrize("out_in", [False, True])
def test_quantize_linear_is_bit_equal_to_jax(out_in):
    w = _tied_weight(np.random.default_rng(0), 64, 24)
    want = jquant.quantize_linear(jnp.asarray(w))
    got = quant.quantize_linear(torch.from_numpy(np.ascontiguousarray(w.T if out_in else w)),
                                out_in=out_in)
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32 and got.out_in == out_in
    np.testing.assert_array_equal(got.in_out().numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want["s"]))
    assert got.in_out()[:4, 1].tolist() == [127, 2, 4, -2]           # ties to even
    assert not got.in_out()[:, 0].any()                               # the zero channel


def test_quantize_rows_is_bit_equal_to_jax():
    x = np.random.default_rng(1).standard_normal((5, 3, 16)).astype(np.float32)
    x[0, 0] = np.array([127, 2.5, -3.5, 0.5] * 4, np.float32) / 64
    x[1, 1] = 0.0
    want_q, want_s = jquant.quantize_rows(jnp.asarray(x))
    got_q, got_s = quant.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_quantize_linear_refuses_a_rounded_copy():
    with pytest.raises(ValueError, match="fp32"):
        quant.quantize_linear(torch.zeros(8, 8, dtype=torch.bfloat16))


@pytest.mark.parametrize("out_in", [False, True])
@pytest.mark.parametrize("M", [1, 16, 17, 64])
def test_int8_linear_matches_jax(M, out_in):
    """M = 1 and 16 take the rows padded for ``_int_mm``; 17 does not."""
    rng = np.random.default_rng(M)
    x = rng.standard_normal((M, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 40)) * 0.05).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    want = np.asarray(jquant.int8_linear(jnp.asarray(x), jquant.quantize_linear(jnp.asarray(w)),
                                         jnp.asarray(b)))
    qw = quant.quantize_linear(torch.from_numpy(np.ascontiguousarray(w.T if out_in else w)),
                               out_in=out_in)
    got = quant.int8_linear(torch.from_numpy(x), qw, torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (M, 40)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    lead = quant.int8_linear(torch.from_numpy(x).reshape(1, M, 64), qw, torch.from_numpy(b))
    torch.testing.assert_close(lead[0], got, rtol=0, atol=0)


@pytest.fixture(scope="module")
def tiny_gpt2():
    cfg = jgpt2.GPT2_PRESETS["gpt2-test"]
    params = jgpt2.init_gpt2(cfg, seed=2)
    lm = convert.gpt2_from_params(_np(params), gpt2.get_gpt2_config("gpt2-test"))
    return params, cfg, lm


def test_int8_gpt2_logits_match_jax(tiny_gpt2):
    params, cfg, lm = tiny_gpt2
    qlm = quant.quantize_gpt2_int8(lm)
    embeds = np.random.default_rng(5).standard_normal((2, 7, cfg.n_embd)).astype(np.float32)
    want, _ = jgpt2.gpt2_apply(jquant.quantize_gpt2_int8(params), cfg,
                               inputs_embeds=jnp.asarray(embeds), dtype=jnp.float32)
    got, _ = gpt2.gpt2_apply(qlm, inputs_embeds=torch.from_numpy(embeds))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    plain, _ = gpt2.gpt2_apply(lm, inputs_embeds=torch.from_numpy(embeds))
    assert 0 < (got - plain).abs().max() < 0.05 * plain.abs().max()  # int8, but close


def test_a_jax_quantized_tree_converts_to_the_ports_quantization(tiny_gpt2):
    params, cfg, lm = tiny_gpt2
    qlm = quant.quantize_gpt2_int8(lm)
    loaded = convert.gpt2_from_params(_np(jquant.quantize_gpt2_int8(params)), lm.config)
    assert isinstance(loaded.h[1].mlp.c_fc.weight, Int8Weight)
    want = qlm.state_dict()
    got = loaded.state_dict()
    assert got.keys() == want.keys() and "h.0.attn.c_attn.weight.q" in got
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)
    tree = convert.gpt2_params(qlm)                  # and back to the JAX form
    jtree = _np(jquant.quantize_gpt2_int8(params))
    for key in ("c_attn", "c_proj"):
        for field in ("q", "s"):
            np.testing.assert_array_equal(tree["h"]["attn"][key]["w"][field],
                                          jtree["h"]["attn"][key]["w"][field])
    np.testing.assert_array_equal(tree["wte"], jtree["wte"])

    ccfg = jclip.get_clip_config("test-tiny")
    cparams = _np(jclip.init_clip(ccfg, seed=4))
    tcfg = clip_vit.get_clip_config("test-tiny")
    jq = {**cparams, "visual": _np(jquant.quantize_clip_visual_int8(cparams["visual"]))}
    want = quant.quantize_clip_visual_int8(convert.clip_from_params(cparams, tcfg)).state_dict()
    got = convert.clip_from_params(jq, tcfg).state_dict()
    assert got.keys() == want.keys()
    assert "visual.transformer.resblocks.0.attn.in_proj_weight.q" in got
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)


def test_the_quantized_copy_keeps_every_other_entry(tiny_gpt2):
    """Layer norms, embeddings, biases and entries the quantizer does not
    know are copied as they are; the original keeps its float weights, and
    the copy shares no tensor with it."""
    _, _, lm = tiny_gpt2
    lm.h[0].future_knob = torch.nn.Parameter(torch.ones(2, 3), requires_grad=False)
    lm.h[1].register_buffer("marker", torch.arange(4.0))
    try:
        qlm = quant.quantize_gpt2_int8(lm)
    finally:
        del lm.h[0].future_knob, lm.h[1].marker
    torch.testing.assert_close(qlm.h[0].future_knob, torch.ones(2, 3))
    torch.testing.assert_close(qlm.h[1].marker, torch.arange(4.0))
    for name in ("wte.weight", "wpe.weight", "h.1.ln_2.weight", "h.0.attn.c_attn.bias",
                 "ln_f.bias"):
        torch.testing.assert_close(qlm.get_parameter(name), lm.get_parameter(name),
                                   rtol=0, atol=0)
    assert isinstance(lm.h[0].mlp.c_proj.weight, torch.nn.Parameter)
    pointers = {t.data_ptr() for t in lm.state_dict().values()}
    assert not pointers & {t.data_ptr() for t in qlm.state_dict().values()}

    visual = convert.clip_from_params(_np(jclip.init_clip(jclip.get_clip_config("test-tiny"))),
                                      clip_vit.get_clip_config("test-tiny")).visual
    qv = quant.quantize_clip_visual_int8(visual)
    for name in ("conv1.weight", "class_embedding", "positional_embedding", "ln_pre.weight",
                 "transformer.resblocks.1.ln_1.bias", "ln_post.weight", "proj",
                 "transformer.resblocks.0.attn.in_proj_bias"):
        torch.testing.assert_close(qv.get_parameter(name), visual.get_parameter(name),
                                   rtol=0, atol=0)
    assert isinstance(qv.transformer.resblocks[1].attn.out_proj.weight, Int8Weight)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("int8")
    config = Config(language_model="gpt2-test", prefix_length=4, projection_length=4,
                    transformer_layers=2, transformer_attention_heads=2,
                    encoder_config=EncoderConfig(encoder_model_variant="test-tiny",
                                                 encoder_embedding_size=32))
    model = jclipcap.init_clipcap(config, lm_config=jgpt2.GPT2_PRESETS["gpt2-test"], seed=3)
    jsave_params(str(d / "model.npz"), model.params)
    save_yaml_config(config, str(d / "config.yaml"))
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    Image.fromarray(img).save(d / "image.png")
    return d


def test_int8_weight_captions_equal_jax(checkpoint):
    """Both packages load one checkpoint and quantize its LM, as their
    ``--int8-weights`` does: beam 5 and top-k 1 captions token for token."""
    args = (str(checkpoint / "model.npz"), str(checkpoint / "config.yaml"))
    jmodel, tok = jclipcap.load(*args)
    tmodel, _ = tclipcap.load(*args, device="cpu")
    jmodel.params["lm"] = jquant.quantize_gpt2_int8(jmodel.params["lm"])
    tmodel.language_model = quant.quantize_gpt2_int8(tmodel.language_model)
    emb = np.random.default_rng(1).standard_normal((1, 32)).astype(np.float32)
    prefix = tmodel.transformer_mapper(emb).detach().numpy()
    want = jgen.generate_beam(jmodel, tok, prefix, number_to_generate=5, beam_size=5)
    got = tgen.generate_beam(tmodel, tok, prefix, number_to_generate=5, beam_size=5)
    assert got == want and len(got) == 5
    kw = dict(number_to_generate=2, top_k=1, entry_length=20)
    assert (tgen.generate_nucleus_sampling(tmodel, tok, prefix, **kw)
            == jgen.generate_nucleus_sampling(jmodel, tok, prefix, **kw))


def test_inference_and_eval_clis_take_int8_weights(checkpoint, monkeypatch):
    from clipcap_tpu_torch.eval import base as eval_base
    from clipcap_tpu_torch.inference import demo
    from clipcap_tpu_torch.inference.args import add_inference_args
    from clipcap_tpu_torch.inference.demo import inference_demo

    calls = []
    real = quant.quantize_gpt2_int8
    for module in (demo, eval_base):
        monkeypatch.setattr(module, "quantize_gpt2_int8",
                            lambda lm: calls.append(lm) or real(lm))
    argv = ["--model-path", str(checkpoint / "model.npz"), "--config-path",
            str(checkpoint / "config.yaml"), "--sample-path", str(checkpoint / "image.png"),
            "--device", "cpu", "--number-to-generate", "2", "--top-k", "1"]
    args = add_inference_args(ArgumentParser()).parse_args(argv + ["--int8-weights"])
    assert args.int8_weights
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        assert inference_demo(args) == 0
    lines = log.getvalue().splitlines()
    assert len(calls) == 1 and sum(line.startswith("sim ") for line in lines) == 2
    assert lines[-1].startswith("best")
    eval_args = eval_base.build_parser().parse_args(
        argv + ["--int8-weights", "--allow-fallback-tokenizer"])
    model = eval_base.prepare_model(eval_args)[0]
    assert len(calls) == 2
    assert isinstance(model.language_model.h[0].attn.c_attn.weight, Int8Weight)
    assert model.language_model.wte.weight.dtype == torch.float32


@pytest.fixture(scope="module")
def tiny_clip():
    cfg = jclip.get_clip_config("test-tiny")
    params = _np(jclip.init_clip(cfg, seed=0))
    return params, cfg, convert.clip_from_params(params, clip_vit.get_clip_config("test-tiny"))


@pytest.mark.parametrize("B", [1, 8, 17])
def test_w8a8_vit_matches_jax(tiny_clip, monkeypatch, B):
    """B = 1 and 8: the class-token block's MLP runs on B < 17 rows, padded
    for ``_int_mm``; B = 17 on exactly 17."""
    params, cfg, clip = tiny_clip
    monkeypatch.setenv("CLIPCAP_FUSED_ATTN", "0")
    imgs = np.random.default_rng(B).integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(jclip.clip_encode_image(jquant.quantize_clip_visual_int8(params["visual"]),
                                              cfg.vision, jnp.asarray(imgs), dtype=jnp.float32,
                                              int8_acts=True))
    qclip = quant.quantize_clip_visual_int8(clip)
    got = clip_vit.clip_encode_image(qclip.visual, torch.from_numpy(imgs), int8_acts=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    plain = clip_vit.clip_encode_image(clip.visual, torch.from_numpy(imgs))
    cos = torch.nn.functional.cosine_similarity(got, plain)
    assert cos.min() > 0.995, cos


def test_int8_encoder_reranks_through_the_w8a8_path(tiny_clip, monkeypatch):
    """``CLIPEncoder(int8=True).similarity`` equals ``clip_similarity`` with
    ``int8_acts`` on the quantized model, and the JAX int8 encoder's."""
    from clipcap_tpu.encoders.clip import CLIPEncoder as JEncoder
    from clipcap_tpu_torch.encoders.base import get_encoder
    from clipcap_tpu_torch.encoders.clip import CLIPEncoder
    from clipcap_tpu_torch.utils.clip_tokenizer import tokenize

    params, cfg, clip = tiny_clip
    monkeypatch.setenv("CLIPCAP_FUSED_ATTN", "0")
    img = np.random.default_rng(2).integers(0, 256, (32, 32, 3), dtype=np.uint8)
    captions = ["a dog on a bench", "a red car", "two cats"]
    enc = CLIPEncoder(clip, clip.config, dtype=torch.float32, int8=True)
    assert isinstance(enc.model.visual.transformer.resblocks[0].attn.in_proj_weight, Int8Weight)
    assert isinstance(clip.visual.transformer.resblocks[0].attn.in_proj_weight,
                      torch.nn.Parameter)                 # the caller's model is untouched
    got = enc.similarity(img, captions)
    want_q, _ = clip_vit.clip_similarity(enc.model, torch.from_numpy(img)[None],
                                         torch.as_tensor(tokenize(captions)), int8_acts=True)
    np.testing.assert_array_equal(got, want_q[0].numpy())
    jenc = JEncoder(params, cfg, int8=True, dtype=jnp.float32)
    np.testing.assert_allclose(got, jenc.similarity(img, captions), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(enc(img[None]), jenc(img[None]), rtol=1e-4, atol=1e-4)

    built, _ = get_encoder("clip", "test-tiny", device="cpu", int8=True)
    assert built.int8 and isinstance(built.model.visual.transformer.resblocks[1].mlp.c_fc.weight,
                                     Int8Weight)
    with pytest.raises(NotImplementedError, match="CLAP"):
        get_encoder("clap", "HTSAT-tiny", device="cpu", int8=True)


def test_int8_encoder_preprocess_writes_the_jax_dataset(tmp_path):
    """``--int8-encoder true`` through both packages' preprocess (test-tiny,
    bf16): the same captions, embeddings within 0.02·max|ref|, the whole
    bf16 forward's tolerance."""
    import pandas as pd
    from PIL import Image

    from clipcap_tpu.encoders.args import add_encoder_args as jadd_encoder_args
    from clipcap_tpu.preprocess.args import add_preprocess_args as jadd_preprocess_args
    from clipcap_tpu.preprocess.preprocess import preprocess as jpreprocess
    from clipcap_tpu_torch.encoders.args import add_encoder_args
    from clipcap_tpu_torch.preprocess.args import add_preprocess_args
    from clipcap_tpu_torch.preprocess.preprocess import preprocess

    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)).save(
            raw / f"sample_{i}.png")
        (raw / f"sample_{i}.txt").write_text(f"int8 test image {i}")
    common = ["--input-dataset", str(raw), "--batch-size", "4", "--workers", "1",
              "--encoder-model-variant", "test-tiny", "--int8-encoder", "true"]
    jargs = jadd_encoder_args(jadd_preprocess_args(ArgumentParser())).parse_args(
        [*common, "--output-folder", str(tmp_path / "jax")])
    targs = add_encoder_args(add_preprocess_args(ArgumentParser())).parse_args(
        [*common, "--output-folder", str(tmp_path / "port"), "--device", "cpu"])
    assert jpreprocess(jargs) == 0 and preprocess(targs) == 0
    want = np.load(tmp_path / "jax" / "embeddings" / "embeds_0.npy")
    got = np.load(tmp_path / "port" / "embeddings" / "embeds_0.npy")
    assert got.dtype == np.float32 and got.shape == want.shape == (5, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * np.abs(want).max())
    pd.testing.assert_frame_equal(
        pd.read_parquet(tmp_path / "port" / "captions" / "captions_0.parquet"),
        pd.read_parquet(tmp_path / "jax" / "captions" / "captions_0.parquet"))


# ---------------------------------------------------------------------------
# On the card: the w8a8 product's _int_mm limits
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch._int_mm on CUDA)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 16, 17, 64, 257])
def test_int8_linear_on_the_card_matches_the_cpu(cuda, M):
    rng = np.random.default_rng(M)
    x = torch.from_numpy(rng.standard_normal((M, 1024)).astype(np.float32))
    w = quant.quantize_linear(torch.from_numpy(
        (rng.standard_normal((3072, 1024)) * 0.02).astype(np.float32)), out_in=True)
    b = torch.from_numpy(rng.standard_normal(3072).astype(np.float32))
    want = quant.int8_linear(x, w, b)
    got = quant.int8_linear(x.to(cuda), w.to(cuda), b.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_quantization_on_the_card_is_bit_equal_to_the_cpu(cuda):
    """The scales and the int8 values do not depend on the device: a scale
    one ulp off would move quotients across .5."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((4096, 1024)) * 3).astype(np.float32))
    q, s = quant.quantize_rows(x)
    qg, sg = quant.quantize_rows(x.to(cuda))
    assert torch.equal(qg.cpu(), q) and torch.equal(sg.cpu(), s)
    w = torch.from_numpy((rng.standard_normal((3072, 1024)) * 0.02).astype(np.float32))
    for out_in in (False, True):
        want = quant.quantize_linear(w, out_in=out_in)
        got = quant.quantize_linear(w.to(cuda), out_in=out_in)
        assert torch.equal(got.q.cpu(), want.q) and torch.equal(got.s.cpu(), want.s)
