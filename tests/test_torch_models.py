"""The port's models against the JAX package's, on the same weights.

Weights are the JAX package's seeded trees, turned into the port's modules
by ``clipcap_tpu_torch.convert``; inputs are made with numpy.  Everything
runs in fp32 (JAX at ``Precision.HIGHEST``), so outputs agree to fp32
rounding in another summation order: 1e-4 abs/rel on logits and
embeddings (GPT-2 logits are O(1); a 2-layer tower sums a few hundred
products per output).  The JAX package's own importers read the port's
state dicts, which holds the port to the original checkpoints' key names.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.models import clip_vit as jclip
from clipcap_tpu.models import gpt2 as jgpt2
from clipcap_tpu.models import mapper as jmapper
from clipcap_tpu.models.hf_import import gpt2_params_from_hf
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.models import clip_vit, gpt2, mapper

torch.set_num_threads(1)
HIGHEST = jax.lax.Precision.HIGHEST
TOL = dict(atol=1e-4, rtol=1e-4)
# The JAX references, jitted: op-by-op dispatch costs several times more.
_STATIC = {"cfg", "dtype", "precision", "return_logits", "beam_size", "cache_base", "flash"}


def _jit(fn):
    names = set(inspect.signature(fn).parameters) & _STATIC
    return jax.jit(fn, static_argnames=tuple(names))


jgpt2_apply = _jit(jgpt2.gpt2_apply)
jmapper_apply = _jit(jmapper.mapper_apply)
jclip_encode_image = _jit(jclip.clip_encode_image)
jclip_encode_text = _jit(jclip.clip_encode_text)
jclip_similarity = _jit(jclip.clip_similarity)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same_tree(got, want):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        np.testing.assert_array_equal(np.asarray(flat_g[path]), np.asarray(leaf), err_msg=str(path))


@pytest.fixture(scope="module")
def lm():
    # gpt2-test's body with a short vocabulary: the logits stay O(1) and
    # the JAX side runs quicker.
    tiny = dict(vocab_size=1000, n_positions=64, n_embd=64, n_layer=2, n_head=4, name="tiny")
    cfg = jgpt2.GPT2Config(**tiny)
    params = jgpt2.init_gpt2(cfg, seed=1)
    return params, cfg, convert.gpt2_from_params(_np_tree(params), gpt2.GPT2Config(**tiny))


def test_seeded_init_is_the_jax_init():
    _assert_same_tree(gpt2.init_gpt2(gpt2.GPT2_PRESETS["gpt2-test"], seed=1),
                      jgpt2.init_gpt2(jgpt2.GPT2_PRESETS["gpt2-test"], seed=1))
    mcfg = jmapper.MapperConfig(32, 64, 4, 4, 2, 2, window_size=3, use_pos_embeddings=True)
    _assert_same_tree(mapper.init_mapper(mapper.MapperConfig(**mcfg.to_dict()), seed=2),
                      jmapper.init_mapper(mcfg, seed=2))
    _assert_same_tree(clip_vit.init_clip(clip_vit.CLIP_PRESETS["test-tiny"], seed=4),
                      jclip.init_clip(jclip.CLIP_PRESETS["test-tiny"], seed=4))


def test_gpt2_config_takes_only_the_hf_qkv_packing():
    """The head-major c_attn layout belongs to the unported tensor-parallel
    paths: asking for it raises instead of taking an untested branch."""
    assert gpt2.GPT2Config().qkv_packing == "qkv"
    with pytest.raises(NotImplementedError, match="qkv_packing"):
        gpt2.GPT2Config(qkv_packing="head")


def test_jax_importers_read_port_state_dicts(lm):
    params, cfg, model = lm
    _assert_same_tree(gpt2_params_from_hf(model.state_dict(), cfg), params)
    assert convert.gpt2_params(model).keys() == params.keys()

    jcfg = jmapper.MapperConfig(32, 64, 4, 4, 2, 2)
    mp = jmapper.init_mapper(jcfg, seed=3)
    port = convert.mapper_from_params(_np_tree(mp), mapper.MapperConfig(**jcfg.to_dict()))
    sd = {f"transformer_mapper.{k}": v for k, v in port.state_dict().items()}
    _assert_same_tree(jmapper.mapper_params_from_torch(sd, jcfg), mp)

    ccfg = jclip.CLIP_PRESETS["test-tiny"]
    cp = jclip.init_clip(ccfg, seed=0)
    port = convert.clip_from_params(_np_tree(cp), clip_vit.CLIP_PRESETS["test-tiny"])
    _assert_same_tree(jclip.clip_params_from_openai(port.state_dict(), ccfg), cp)


def test_gpt2_full_sequence_logits(lm):
    params, cfg, model = lm
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, (2, 12))
    mask = np.ones((2, 12), bool)
    mask[1, 9:] = False
    want, _ = jgpt2_apply(params, cfg, input_ids=jnp.asarray(ids),
                               attention_mask=jnp.asarray(mask), precision=HIGHEST)
    got, _ = gpt2.gpt2_apply(model, input_ids=torch.from_numpy(ids),
                             attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gpt2_cached_prefill_and_decode(lm):
    """Prefill P positions, then three single-token steps, in both packages
    (the port's decode attention is the kernel's twin here)."""
    params, cfg, model = lm
    rng = np.random.default_rng(2)
    B, P, steps = 2, 6, 3
    emb = (rng.standard_normal((B, P, cfg.n_embd)) * 0.5).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, (B, steps))
    jc = jgpt2.init_kv_cache(cfg, B, P + steps, dtype=jnp.float32)
    tc = gpt2.init_kv_cache(model.config, B, P + steps, dtype=torch.float32)
    assert tc[0].shape == jc[0].shape
    want, jc = jgpt2_apply(params, cfg, inputs_embeds=jnp.asarray(emb), kv_cache=jc,
                                cache_index=0, precision=HIGHEST)
    got, tc = gpt2.gpt2_apply(model, inputs_embeds=torch.from_numpy(emb), kv_cache=tc,
                              cache_index=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for s in range(steps):
        want, jc = jgpt2_apply(params, cfg, input_ids=jnp.asarray(ids[:, s:s + 1]),
                                    kv_cache=jc, cache_index=P + s, precision=HIGHEST)
        got, tc = gpt2.gpt2_apply(model, input_ids=torch.from_numpy(ids[:, s:s + 1]),
                                  kv_cache=tc, cache_index=P + s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {s}")
    np.testing.assert_allclose(tc[1].numpy(), np.asarray(jc[1]), **TOL)


@pytest.mark.parametrize("fold", [True, False])
def test_gpt2_beam_decode_through_ancestry(lm, fold):
    """One beam-decode step over a cache written by a prefill and earlier
    steps, with a random ancestry table: the folded-prefix layout and the
    replicated one."""
    params, cfg, model = lm
    rng = np.random.default_rng(3)
    R, K, P, N, step = 2, 3, 5, 6, 3
    B = R * K
    emb = (rng.standard_normal((R, P, cfg.n_embd)) * 0.5).astype(np.float32)
    if fold:
        jc = jgpt2.init_kv_cache(cfg, B, N, dtype=jnp.float32, beam_size=K, prefix_slots=P)
        tc = gpt2.init_kv_cache(model.config, B, N, dtype=torch.float32, beam_size=K,
                                prefix_slots=P)
        pre, kw, anc_len, base = emb, {}, N, P
    else:
        jc = jgpt2.init_kv_cache(cfg, B, P + N, dtype=jnp.float32, beam_size=K)
        tc = gpt2.init_kv_cache(model.config, B, P + N, dtype=torch.float32, beam_size=K)
        pre, kw, anc_len, base = np.repeat(emb, K, axis=0), {"beam_size": K}, P + N, 0
    assert tc[0].shape == jc[0].shape
    _, jc = jgpt2_apply(params, cfg, inputs_embeds=jnp.asarray(pre), kv_cache=jc,
                             cache_index=0, precision=HIGHEST, **kw)
    _, tc = gpt2.gpt2_apply(model, inputs_embeds=torch.from_numpy(pre), kv_cache=tc,
                            cache_index=0, **kw)
    ancestry = rng.integers(0, K, (B, anc_len))
    for s in range(step):
        ids = rng.integers(0, cfg.vocab_size, (B, 1))
        want, jc = jgpt2_apply(params, cfg, input_ids=jnp.asarray(ids), kv_cache=jc,
                                    cache_index=P + s, beam_size=K,
                                    ancestry=jnp.asarray(ancestry), cache_base=base,
                                    precision=HIGHEST)
        got, tc = gpt2.gpt2_apply(model, input_ids=torch.from_numpy(ids), kv_cache=tc,
                                  cache_index=P + s, beam_size=K,
                                  ancestry=torch.from_numpy(ancestry), cache_base=base)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"step {s}")


@pytest.mark.parametrize("windowed", [False, True])
def test_mapper_matches_jax(windowed):
    kw = dict(window_size=3, use_pos_embeddings=True) if windowed else {}
    jcfg = jmapper.MapperConfig(32, 64, prefix_length=4, projection_length=3, num_heads=4,
                                num_layers=2, **kw)
    params = jmapper.init_mapper(jcfg, seed=5)
    port = convert.mapper_from_params(_np_tree(params), mapper.MapperConfig(**jcfg.to_dict()))
    shape = (2, 3, 32) if windowed else (2, 32)
    emb = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    want = jmapper_apply(params, jcfg, jnp.asarray(emb), precision=HIGHEST)
    got = port(emb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def tiny_clip():
    jcfg = jclip.CLIPConfig(
        name="t",
        vision=jclip.CLIPVisionConfig(image_size=32, patch_size=8, width=64, layers=2, heads=4,
                                      embed_dim=32),
        text=jclip.CLIPTextConfig(vocab_size=300, context_length=16, width=64, layers=2,
                                  heads=4, embed_dim=32))
    params = jclip.init_clip(jcfg, seed=0)
    cfg = clip_vit.CLIPConfig("t", clip_vit.CLIPVisionConfig(**vars(jcfg.vision)),
                              clip_vit.CLIPTextConfig(**vars(jcfg.text)))
    return params, jcfg, convert.clip_from_params(_np_tree(params), cfg)


def test_clip_encode_image_uint8(tiny_clip):
    params, jcfg, port = tiny_clip
    imgs = np.random.default_rng(7).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    want = jclip_encode_image(params["visual"], jcfg.vision, jnp.asarray(imgs),
                                   precision=HIGHEST)
    got = clip_vit.clip_encode_image(port.visual, torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_clip_encode_text_and_similarity(tiny_clip):
    params, jcfg, port = tiny_clip
    rng = np.random.default_rng(8)
    tokens = np.zeros((3, 16), np.int32)
    for i, n in enumerate((4, 9, 16)):
        tokens[i, :n - 1] = rng.integers(1, 298, n - 1)
        tokens[i, n - 1] = 299                          # EOT: the largest id
    want = jclip_encode_text(params["text"], jcfg.text, jnp.asarray(tokens),
                                  precision=HIGHEST)
    got = clip_vit.clip_encode_text(port, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    imgs = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    want, _ = jclip_similarity(params, jcfg, jnp.asarray(imgs), jnp.asarray(tokens),
                                    precision=HIGHEST)
    got, _ = clip_vit.clip_similarity(port, torch.from_numpy(imgs), torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_clip_loads_a_local_openai_checkpoint(tiny_clip, tmp_path):
    """An OpenAI-format state dict (the layout ``clip.load`` reads) loads
    by ``load_state_dict``; the config comes from its shapes."""
    params, jcfg, port = tiny_clip
    sd = dict(port.state_dict(), input_resolution=torch.tensor(32))   # a non-weight entry
    torch.save({k: v.half() for k, v in sd.items()}, tmp_path / "tiny.pt")
    loaded, cfg = clip_vit.load_clip("ViT-B/32", checkpoint_path=str(tmp_path / "tiny.pt"))
    assert (cfg.vision.width, cfg.vision.patch_size, cfg.vision.image_size) == (64, 8, 32)
    assert (cfg.text.layers, cfg.text.context_length, cfg.text.vocab_size) == (2, 16, 300)
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, port.state_dict()[k].half().float(), rtol=0, atol=0)
