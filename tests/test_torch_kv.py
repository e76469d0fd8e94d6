"""The port's int8 KV cache and converged-prefix consolidation against the
JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
side runs as its own tests run it on the CPU: the Pallas decode kernels in
interpret mode, and ``beam_search_batched`` / ``engine.decode`` on their
XLA path.  The port's side is the kernels' plain twins, which is what a CPU
tensor reaches.  Tolerances: fp32 1e-5 abs (the same fp32 arithmetic in
another summation order), bf16 2e-2 abs (the two round the bf16 operands at
other places); beam scores 1e-4.  The tests marked ``cuda`` hold the CUDA
kernels to their twins on the card and skip without one.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.inference import engine as jengine
from clipcap_tpu.inference.beam import BeamParams as JBeamParams
from clipcap_tpu.inference.beam import beam_search_batched as jbeam_search_batched
from clipcap_tpu.models import gpt2 as jgpt2
from clipcap_tpu.ops.flash_decode import flash_decode as jflash_decode
from clipcap_tpu.ops.flash_decode import flash_decode_two_phase as jflash_two_phase
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.inference import engine
from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
from clipcap_tpu_torch.models import gpt2
from clipcap_tpu_torch.models.gpt2 import NEG_INF
from clipcap_tpu_torch.ops.flash_decode import (flash_decode, flash_decode_ref,
                                                flash_decode_two_phase,
                                                flash_decode_two_phase_ref)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
TOL = {np.float32: 1e-5, "bfloat16": 2e-2}
TINY = dict(vocab_size=211, n_positions=64, n_embd=32, n_layer=2, n_head=4, name="t")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _int8_cache(rng, R, H, U, Dh=64):
    rows = rng.integers(-127, 128, (R, H, U, 2 * Dh)).astype(np.int8)
    sk = rng.uniform(0.005, 0.03, (R, H, U)).astype(np.float32)
    sv = rng.uniform(0.005, 0.03, (R, H, U)).astype(np.float32)
    return rows, sk, sv


def _bounded_mask(rng, R, K, U, lo, hi):
    """A random visible pattern inside each row's [lo, hi) (its first slot
    always visible), NEG_INF outside: the JAX kernel reads whole tiles and
    relies on the mask for the slack."""
    vis = rng.random((R, K, U)) < 0.6
    for r in range(R):
        vis[r, :, :lo[r]] = False
        vis[r, :, hi[r]:] = False
        vis[r, :, lo[r]] = True
    return np.where(vis, 0.0, NEG_INF).astype(np.float32)


def _both(q, dtype):
    """q as (jax array, torch tensor) in ``dtype`` ("float32"/"bfloat16")."""
    jq = jnp.asarray(q).astype(dtype)
    return jq, _t(np.asarray(jq.astype(jnp.float32))).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# Decode attention: the int8 form, per-row bounds and the carry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("per_row", [False, True])
def test_flash_decode_int8_ref_matches_pallas(dtype, K, per_row):
    rng = np.random.default_rng(K * 2 + per_row)
    R, H, U = 3, 4, 128
    jq, tq = _both(rng.standard_normal((R, H, K, 64)).astype(np.float32), dtype)
    rows, sk, sv = _int8_cache(rng, R, H, U)
    if per_row:
        lo, hi = np.array([0, 5, 70], np.int32), np.array([40, 128, 71], np.int32)
        jlo, jhi, tlo, thi = jnp.asarray(lo), jnp.asarray(hi), _t(lo), _t(hi)
    else:
        lo, hi = np.full(R, 9, np.int32), np.full(R, 100, np.int32)
        jlo, jhi, tlo, thi = 9, 100, 9, 100
    mask = _bounded_mask(rng, R, K, U, lo, hi)
    want = jflash_decode(jq, jnp.asarray(rows), jnp.asarray(mask), u_valid=jhi,
                         scales=(jnp.asarray(sk), jnp.asarray(sv)), u_lo=jlo, interpret=True)
    got = flash_decode_ref(tq, _t(rows), _t(mask), thi, scales=(_t(sk), _t(sv)), u_lo=tlo)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL.get(dtype, 1e-5), rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_flash_decode_carry_resumes_as_one_call(int8):
    """Phase A's partials over one buffer, resumed by phase B over another
    from ``u_lo``, equal one call over the concatenation; A's (m, l, acc)
    equal the Pallas kernel's (its acc carries both halves of the row)."""
    rng = np.random.default_rng(9 + int8)
    R, H, K, U, Sc = 2, 3, 5, 256, 128
    q = rng.standard_normal((R, H, K, 64)).astype(np.float32)
    if int8:
        kv, ksk, ksv = _int8_cache(rng, R, H, U)
        sh, ssk, ssv = _int8_cache(rng, R, H, Sc)
        kvs, shs = (_t(ksk), _t(ksv)), (_t(ssk), _t(ssv))
        jkvs, jshs = (jnp.asarray(ksk), jnp.asarray(ksv)), (jnp.asarray(ssk), jnp.asarray(ssv))
    else:
        kv = rng.standard_normal((R, H, U, 128)).astype(np.float32)
        sh = rng.standard_normal((R, H, Sc, 128)).astype(np.float32)
        kvs = shs = jkvs = jshs = None
    for c in (0, 1, 40, 128):
        for live_valid in (129, 256):
            sh_mask = np.broadcast_to(np.where(np.arange(Sc) < c, 0.0, NEG_INF),
                                      (1, K, Sc)).astype(np.float32)
            live_mask = np.broadcast_to(np.where(np.arange(U) < live_valid, 0.0, NEG_INF),
                                        (1, K, U)).copy()
            live_mask[:, :, :c // 2] = NEG_INF          # phase B skips what A served
            part = flash_decode_ref(_t(q), _t(sh), _t(sh_mask), c, scales=shs,
                                    return_carry=True)
            two = flash_decode_ref(_t(q), _t(kv), _t(live_mask), live_valid, scales=kvs,
                                   u_lo=c // 2, carry=part)
            one = flash_decode_ref(
                _t(q), torch.cat([_t(sh), _t(kv)], dim=2),
                torch.cat([_t(sh_mask), _t(live_mask)], dim=2), None,
                scales=None if not int8 else tuple(torch.cat(p, dim=2)
                                                   for p in zip(shs, kvs)))
            np.testing.assert_allclose(two.numpy(), one.numpy(), atol=1e-5, rtol=0,
                                       err_msg=f"c={c} live_valid={live_valid}")
            if c == 0:
                continue          # the JAX kernel reads a whole masked tile there
            jpart = jflash_decode(jnp.asarray(q), jnp.asarray(sh), jnp.asarray(sh_mask),
                                  u_valid=c, scales=jshs, return_carry=True, interpret=True)
            jtwo = jflash_decode(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(live_mask),
                                 u_valid=live_valid, scales=jkvs, u_lo=c // 2, carry=jpart,
                                 interpret=True)
            for got, want in zip(part, (jpart[0], jpart[1], jpart[2][..., 64:])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                           rtol=1e-5)
            np.testing.assert_allclose(two.numpy(), np.asarray(jtwo), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shared_int8,live_int8",
                         [(False, False), (True, False), (False, True), (True, True)])
def test_flash_decode_two_phase_ref_matches_pallas(shared_int8, live_int8):
    """Per-sample shared lengths, live lows and live ends, all different."""
    rng = np.random.default_rng(11 + 2 * shared_int8 + live_int8)
    R, H, K, Sc, U = 4, 3, 5, 128, 256
    q = rng.standard_normal((R, H, K, 64)).astype(np.float32)

    def region(int8, n):
        if int8:
            rows, sk, sv = _int8_cache(rng, R, H, n)
            return rows, (sk, sv)
        return rng.standard_normal((R, H, n, 128)).astype(np.float32), None

    sh, sh_s = region(shared_int8, Sc)
    kv, kv_s = region(live_int8, U)
    c = np.array([1, 17, 40, 127], np.int32)
    lv_lo = np.array([0, 30, 85, 100], np.int32)
    lv_valid = np.array([64, 101, 256, 140], np.int32)
    sh_mask = _bounded_mask(rng, R, K, Sc, np.zeros(R, np.int32), c)
    live_mask = _bounded_mask(rng, R, K, U, lv_lo, lv_valid)
    want = jflash_two_phase(
        jnp.asarray(q), jnp.asarray(sh), jnp.asarray(sh_mask), jnp.asarray(kv),
        jnp.asarray(live_mask), sh_valid=jnp.asarray(c), lv_lo=jnp.asarray(lv_lo),
        lv_valid=jnp.asarray(lv_valid),
        shared_scales=None if sh_s is None else tuple(map(jnp.asarray, sh_s)),
        live_scales=None if kv_s is None else tuple(map(jnp.asarray, kv_s)), interpret=True)
    got = flash_decode_two_phase_ref(
        _t(q), _t(sh), _t(sh_mask), _t(kv), _t(live_mask), _t(c), _t(lv_lo), _t(lv_valid),
        shared_scales=None if sh_s is None else tuple(map(_t, sh_s)),
        live_scales=None if kv_s is None else tuple(map(_t, kv_s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # The wrapper takes the twin for CPU tensors and counts no launch.
    before = flash_decode_two_phase.launches
    same = flash_decode_two_phase(
        _t(q), _t(sh), _t(sh_mask), _t(kv), _t(live_mask), _t(c), _t(lv_lo), _t(lv_valid),
        shared_scales=None if sh_s is None else tuple(map(_t, sh_s)),
        live_scales=None if kv_s is None else tuple(map(_t, kv_s)))
    assert torch.equal(same, got) and flash_decode_two_phase.launches == before


# ---------------------------------------------------------------------------
# The cache: quantisation, consolidation, one consolidated step
# ---------------------------------------------------------------------------


def test_quantize_kv_is_the_jax_quantisation_bit_for_bit():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 7, 128)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                                   # an all-zero slot: the 1e-8 floor
    x[1, 2, 3, :64] = np.linspace(-127, 127, 64) * 0.5  # exact .5 ties: half to even
    want = jgpt2._quantize_kv(jnp.asarray(x), 64)
    got = gpt2._quantize_kv(_t(x), 64)
    for g, w in zip(got, want):
        assert g.dtype == {np.int8: torch.int8, np.float32: torch.float32}[np.asarray(w).dtype.type]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("int8", [False, True])
def test_consolidate_kv_cache_matches_jax(int8):
    rng = np.random.default_rng(5)
    cfg = jgpt2.GPT2Config(**TINY)
    R, K, P, N = 3, 3, 6, 12
    jlive = jgpt2.init_kv_cache(cfg, R * K, N, dtype=jnp.float32, beam_size=K, int8=int8)
    jshared = jgpt2.init_shared_kv(cfg, R, P + N, dtype=jnp.float32, int8=int8)

    def fill(tree):
        return jax.tree_util.tree_map(
            lambda a: (rng.integers(-127, 128, a.shape).astype(np.int8) if a.dtype == jnp.int8
                       else rng.standard_normal(a.shape).astype(np.float32)), tree)

    jlive, jshared = fill(jlive), fill(jshared)
    slots = (jshared[0][0] if int8 else jshared[0]).shape[2]
    rows = rng.integers(0, K, (R, slots - P)).astype(np.int32)
    want = jgpt2.consolidate_kv_cache(jax.tree_util.tree_map(jnp.asarray, jlive),
                                      jax.tree_util.tree_map(jnp.asarray, jshared),
                                      jnp.asarray(rows), K, base=P)
    to_t = (lambda layer: tuple(_t(a.copy()) for a in layer)) if int8 else (
        lambda layer: _t(layer.copy()))
    got = gpt2.consolidate_kv_cache([to_t(x) for x in jlive], [to_t(x) for x in jshared],
                                    _t(rows), K, base=P)
    for g, w in zip(jax.tree_util.tree_leaves([list(x) if int8 else x for x in got]),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("int8", [False, True])
def test_consolidated_decode_step_matches_pallas(int8):
    """One consolidated beam step of ``gpt2_apply``, fp32: the JAX package
    through its Pallas two-phase kernel (interpret), the port through the
    twin, with a per-sample converged length."""
    tiny = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4, name="t")
    jcfg = jgpt2.GPT2Config(**tiny)
    params = jgpt2.init_gpt2(jcfg, seed=1)
    model = convert.gpt2_from_params(jax.tree_util.tree_map(np.asarray, params),
                                     gpt2.GPT2Config(**tiny))
    rng = np.random.default_rng(13)
    R, K, P, N = 2, 3, 4, 12
    B = R * K
    prefix = rng.standard_normal((R, P, 64)).astype(np.float32)
    steps = rng.standard_normal((5, B, 1, 64)).astype(np.float32)
    anc = np.tile(np.arange(K, dtype=np.int32)[:, None], (R, N)).reshape(B, N)
    c = np.array([P + 2, P + 1], np.int32)
    anc2 = anc.copy().reshape(R, K, N)
    anc2[0, :, :2] = 0
    anc2[1, :, :1] = 0
    anc2 = anc2.reshape(B, N)

    # JAX: prefill to shared, four live steps, consolidate, one step.
    jshared = jgpt2.init_shared_kv(jcfg, R, P + N, dtype=jnp.float32, int8=int8)
    _, jshared = jgpt2.gpt2_apply(params, jcfg, inputs_embeds=jnp.asarray(prefix),
                                  kv_cache=jshared, cache_index=jnp.int32(0),
                                  dtype=jnp.float32, flash=False)
    jlive = jgpt2.init_kv_cache(jcfg, B, N, dtype=jnp.float32, beam_size=K, int8=int8)
    for i in range(4):
        _, jlive = jgpt2.gpt2_apply(params, jcfg, inputs_embeds=jnp.asarray(steps[i]),
                                    kv_cache=jlive, cache_index=jnp.int32(P + i),
                                    dtype=jnp.float32, beam_size=K, ancestry=jnp.asarray(anc),
                                    shared_kv=jshared, shared_len=jnp.int32(P), cache_base=P,
                                    flash=False)
    slots = (jshared[0][0] if int8 else jshared[0]).shape[2]
    rows = np.zeros((R, slots - P), np.int32)
    jshared = jgpt2.consolidate_kv_cache(jlive, jshared, jnp.asarray(rows), K, base=P)
    want, _ = jgpt2.gpt2_apply(params, jcfg, inputs_embeds=jnp.asarray(steps[4]),
                               kv_cache=jlive, cache_index=jnp.int32(P + 4), dtype=jnp.float32,
                               beam_size=K, ancestry=jnp.asarray(anc2), shared_kv=jshared,
                               shared_len=jnp.asarray(c), cache_base=P, flash=True)

    # The port, the same calls.
    shared = gpt2.init_shared_kv(model.config, R, P + N, dtype=torch.float32, int8=int8)
    _, shared = gpt2.gpt2_apply(model, inputs_embeds=_t(prefix), kv_cache=shared, cache_index=0)
    live = gpt2.init_kv_cache(model.config, B, N, dtype=torch.float32, beam_size=K, int8=int8)
    for i in range(4):
        _, live = gpt2.gpt2_apply(model, inputs_embeds=_t(steps[i]), kv_cache=live,
                                  cache_index=P + i, beam_size=K, ancestry=_t(anc),
                                  shared_kv=shared, shared_len=P, cache_base=P)
    gpt2.consolidate_kv_cache(live, shared, _t(rows), K, base=P)
    got, _ = gpt2.gpt2_apply(model, inputs_embeds=_t(steps[4]), kv_cache=live,
                             cache_index=P + 4, beam_size=K, ancestry=_t(anc2),
                             shared_kv=shared, shared_len=_t(c), cache_base=P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The decode loops
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_lm():
    params = jgpt2.init_gpt2(jgpt2.GPT2Config(**TINY))
    model = convert.gpt2_from_params(jax.tree_util.tree_map(np.asarray, params),
                                     gpt2.GPT2Config(**TINY))
    prefix = np.random.default_rng(3).normal(size=(3, 6, 32)).astype(np.float32)
    return params, model, prefix


@pytest.mark.parametrize("int8", [False, True])
def test_beam_search_int8_and_consolidation_match_jax(tiny_lm, int8):
    """fp32 beam 3, 12 new tokens, C ∈ {0, 1, 3}: tokens equal JAX's and
    the port's own C = 0 tokens, scores within 1e-4."""
    params, model, prefix = tiny_lm
    base = dict(beam_size=3, max_new_tokens=12, stop_token=5, int8_kv=int8)
    own = None
    for C in (0, 1, 3):
        want = jbeam_search_batched(params, jgpt2.GPT2Config(**TINY), jnp.asarray(prefix),
                                    JBeamParams(**base, consolidate_every=C),
                                    dtype=jnp.float32)
        got = beam_search_batched(model, _t(prefix), BeamParams(**base, consolidate_every=C),
                                  dtype=torch.float32)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens),
                                      err_msg=f"C={C}")
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-4)
        np.testing.assert_allclose(got.seq_lengths.numpy(), np.asarray(want.seq_lengths))
        own = got.tokens if own is None else own
        assert torch.equal(got.tokens, own), f"C={C} differs from C=0"


def test_consolidation_moves_converged_positions(tiny_lm):
    """Every-step consolidation grows each sample's converged length past
    the prefix, one bound per sample (the shared region is really used)."""
    from unittest import mock

    from clipcap_tpu_torch.inference import beam

    _, model, prefix = tiny_lm
    seen = []

    def spy(*args, **kw):
        if kw.get("shared_len") is not None:
            seen.append(kw["shared_len"].clone())
        return gpt2.gpt2_apply(*args, **kw)

    with mock.patch.object(beam, "gpt2_apply", spy):
        beam_search_batched(model, _t(prefix), BeamParams(beam_size=3, max_new_tokens=12,
                                                          stop_token=5, consolidate_every=1),
                            dtype=torch.float32)
    assert seen and all(s.dtype == torch.int32 and s.shape == (3,) for s in seen)
    assert int(seen[-1].max()) > 6 and bool((seen[-1] >= seen[0]).all())


def test_engine_decode_int8_matches_jax_at_top_k_1(tiny_lm):
    params, model, prefix = tiny_lm
    kw = dict(max_new_tokens=10, top_k=1, stop_token=7, mode="sample", int8_kv=True)
    want = jengine.decode(params, jgpt2.GPT2Config(**TINY), jnp.asarray(prefix),
                          jax.random.PRNGKey(0), jengine.SamplingParams(**kw), dtype=jnp.float32)
    got = engine.decode(model, _t(prefix), torch.Generator().manual_seed(0),
                        engine.SamplingParams(**kw), dtype=torch.float32)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    base = engine.decode(model, _t(prefix), torch.Generator().manual_seed(0),
                         dataclasses.replace(engine.SamplingParams(**kw), int8_kv=False),
                         dtype=torch.float32)
    assert got.tokens.shape == base.tokens.shape


def test_inference_cli_int8_kv_cache(tmp_path):
    """``python -m clipcap_tpu_torch.inference --device cpu --int8-kv-cache``
    on a tiny checkpoint, in a fresh interpreter: exit 0, N captions."""
    from PIL import Image

    from clipcap_tpu_torch.config import Config, EncoderConfig, save_yaml_config
    from clipcap_tpu_torch.models.clipcap import init_clipcap
    from clipcap_tpu_torch.train.checkpoint import save_params

    config = Config(language_model="gpt2-test", prefix_length=4, projection_length=4,
                    transformer_layers=2, transformer_attention_heads=2,
                    encoder_config=EncoderConfig(encoder_model_variant="test-tiny",
                                                 encoder_embedding_size=32))
    model = init_clipcap(config, lm_config=gpt2.GPT2_PRESETS["gpt2-test"], seed=3)
    save_params(str(tmp_path / "model.npz"), model.params())
    save_yaml_config(config, str(tmp_path / "config.yaml"))
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (40, 48, 3), dtype=np.uint8)
                    ).save(tmp_path / "image.png")
    env = dict(os.environ, PYTHONPATH=str(REPO), HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1",
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(
        [sys.executable, "-m", "clipcap_tpu_torch.inference", "--device", "cpu",
         "--int8-kv-cache", "--model-path", str(tmp_path / "model.npz"), "--config-path",
         str(tmp_path / "config.yaml"), "--sample-path", str(tmp_path / "image.png"),
         "--number-to-generate", "3"],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert sum(line.startswith("sim ") for line in res.stdout.splitlines()) == 3
    assert "best" in res.stdout


# ---------------------------------------------------------------------------
# The kernels against their twins (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# fp32: another summation order (1e-4 abs); bf16: the twin rounds the
# softmax weights to bf16 and the kernel keeps them fp32 (2e-2 abs).
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _cuda_int8(g, R, H, U, dev):
    rows = torch.randint(-127, 128, (R, H, U, 128), generator=g, device=dev).to(torch.int8)
    sk = torch.rand(R, H, U, generator=g, device=dev) * 0.01 + 0.005
    sv = torch.rand(R, H, U, generator=g, device=dev) * 0.01 + 0.005
    return rows, (sk, sv)


def _cuda_mask(g, Rm, K, U, dev):
    mask = torch.where(torch.rand(Rm, K, U, generator=g, device=dev) < 0.5, 0.0, NEG_INF)
    mask[..., 0] = 0.0
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 5])
def test_flash_decode_int8_kernel_matches_twin(cuda, dtype, K):
    g = torch.Generator(device=cuda).manual_seed(K)
    R, H, U = 4, 3, 384
    q = torch.randn(R, H, K, 64, generator=g, device=cuda).to(dtype)
    rows, scales = _cuda_int8(g, R, H, U, cuda)
    mask = _cuda_mask(g, R, K, U, cuda)
    before = flash_decode.int8_launches
    for lo, hi in ((0, 1), (0, 64), (3, 65), (0, 215), (100, 384)):
        got = flash_decode(q, rows, mask, hi, scales=scales, u_lo=lo)
        want = flash_decode_ref(q, rows, mask, hi, scales=scales, u_lo=lo)
        torch.testing.assert_close(got.float(), want.float(), atol=KERNEL_TOL[dtype], rtol=0)
    assert flash_decode.int8_launches == before + 5


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_flash_decode_kernel_per_row_bounds_and_carry(cuda, int8):
    g = torch.Generator(device=cuda).manual_seed(3)
    R, H, K, U = 4, 3, 5, 256
    q = torch.randn(R, H, K, 64, generator=g, device=cuda)
    if int8:
        kv, scales = _cuda_int8(g, R, H, U, cuda)
    else:
        kv, scales = torch.randn(R, H, U, 128, generator=g, device=cuda), None
    mask = _cuda_mask(g, R, K, U, cuda)
    lo = torch.tensor([0, 7, 64, 200], dtype=torch.int32, device=cuda)
    hi = torch.tensor([1, 130, 64, 256], dtype=torch.int32, device=cuda)
    got = flash_decode(q, kv, mask, hi, scales=scales, u_lo=lo)
    want = flash_decode_ref(q, kv, mask, hi, scales=scales, u_lo=lo)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    # Carry: [0, 100) then [100, 256) resumed equals one call over [0, 256).
    part = flash_decode(q, kv, mask, 100, scales=scales, return_carry=True)
    part_ref = flash_decode_ref(q, kv, mask, 100, scales=scales, return_carry=True)
    for a, b in zip(part, part_ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)
    two = flash_decode(q, kv, mask, U, scales=scales, u_lo=100, carry=part)
    torch.testing.assert_close(two, flash_decode_ref(q, kv, mask, U, scales=scales),
                               atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared_int8,live_int8",
                         [(False, False), (True, False), (False, True), (True, True)])
def test_flash_decode_two_phase_kernel_matches_twin(cuda, dtype, shared_int8, live_int8):
    g = torch.Generator(device=cuda).manual_seed(11)
    R, H, K, Us, Ul = 4, 3, 5, 128, 384
    q = torch.randn(R, H, K, 64, generator=g, device=cuda).to(dtype)

    def region(int8, n):
        if int8:
            return _cuda_int8(g, R, H, n, cuda)
        return torch.randn(R, H, n, 128, generator=g, device=cuda).to(dtype), None

    sh, sh_s = region(shared_int8, Us)
    lv, lv_s = region(live_int8, Ul)
    sh_mask, lv_mask = _cuda_mask(g, R, K, Us, cuda), _cuda_mask(g, R, K, Ul, cuda)
    c = torch.tensor([10, 17, 64, 77], dtype=torch.int32, device=cuda)
    lv_lo = (c - 10) * K
    before = flash_decode_two_phase.launches
    for lv_valid in (5, 215, 335):
        args = (q, sh, sh_mask, lv, lv_mask, c, lv_lo.to(torch.int32), lv_valid)
        got = flash_decode_two_phase(*args, shared_scales=sh_s, live_scales=lv_s)
        want = flash_decode_two_phase_ref(*args, shared_scales=sh_s, live_scales=lv_s)
        torch.testing.assert_close(got.float(), want.float(), atol=KERNEL_TOL[dtype], rtol=0)
    assert flash_decode_two_phase.launches == before + 3


@pytest.mark.cuda
def test_two_phase_kernel_launches_on_its_tensors_stream(cuda):
    """The launch goes to the current stream of the tensors' device: behind
    a spin on a side stream, the result is still the twin's."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    g = torch.Generator(device=dev).manual_seed(5)
    R, H, K = 2, 3, 5
    q = torch.randn(R, H, K, 64, generator=g, device=dev)
    sh, sh_s = _cuda_int8(g, R, H, 128, dev)
    lv, lv_s = _cuda_int8(g, R, H, 128, dev)
    sh_mask, lv_mask = _cuda_mask(g, R, K, 128, dev), _cuda_mask(g, R, K, 128, dev)
    want = flash_decode_two_phase_ref(q, sh, sh_mask, lv, lv_mask, 30, 0, 100, sh_s, lv_s)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        lv.zero_()                   # the kernel must see this write
        got = flash_decode_two_phase(q, sh, sh_mask, lv, lv_mask, 30, 0, 100, sh_s, lv_s)
    torch.cuda.synchronize(dev)
    zero = flash_decode_two_phase_ref(q, sh, sh_mask, lv, lv_mask, 30, 0, 100, sh_s, lv_s)
    torch.testing.assert_close(got, zero, atol=1e-4, rtol=0)
    assert not torch.allclose(zero, want)
