"""The port's tile-major KV cache and manual-pipeline decode attention
against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
side runs as its own tests run it on the CPU: ``flash_decode(manual=True)``
in Pallas interpret mode, and the decode loops on their XLA path
(``flash=False``).  The port's side is the kernels' plain twin, which is
what a CPU tensor reaches; it reads a tile-major cache through its logical
view.  Everything is fp32: 1e-6 abs / 1e-5 rel for one attention call (the
same arithmetic in another summation order), 1e-5 for a cache after many
steps, token equality for the decode loops.  The tests marked ``cuda`` hold
both CUDA kernels to the twin on the card and skip without one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.inference import engine as jengine
from clipcap_tpu.inference.beam import BeamParams as JBeamParams
from clipcap_tpu.inference.beam import beam_search_batched as jbeam_search_batched
from clipcap_tpu.models import gpt2 as jgpt2
from clipcap_tpu.ops import flash_decode as jfd
from clipcap_tpu_torch import convert
from clipcap_tpu_torch.inference import engine
from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
from clipcap_tpu_torch.models import gpt2
from clipcap_tpu_torch.models.gpt2 import NEG_INF
from clipcap_tpu_torch.ops import flash_decode as fd
from clipcap_tpu_torch.ops.flash_decode import _pick_u_tile, flash_decode, flash_decode_ref

torch.set_num_threads(1)
TINY = dict(vocab_size=211, n_positions=256, n_embd=64, n_layer=2, n_head=4, name="t")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _to_tile_major(kv: np.ndarray, u: int) -> np.ndarray:
    """[R, H, U, D2] → [R, U // u, H, u, D2]."""
    R, H, U, D2 = kv.shape
    return np.ascontiguousarray(kv.reshape(R, H, U // u, u, D2).transpose(0, 2, 1, 3, 4))


# ---------------------------------------------------------------------------
# The u-tile and the cache shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env", [None, "16", "40", "64", "96"])
def test_pick_u_tile_matches_jax(monkeypatch, env):
    """U = 16..1024 under the default cap and explicit caps, with and
    without ``CLIPCAP_FLASH_U_TILE`` (the JAX module reads it at import:
    its two module constants are set as that import would set them)."""
    if env is None:
        monkeypatch.delenv("CLIPCAP_FLASH_U_TILE", raising=False)
    else:
        monkeypatch.setenv("CLIPCAP_FLASH_U_TILE", env)
    monkeypatch.setattr(jfd, "_U_TILE", 64 if env is None else int(env))
    monkeypatch.setattr(jfd, "_U_TILE_OVERRIDDEN", env is not None)
    for U in range(16, 1025):
        for cap in (None, 8, 16, 40, 64, 80, 128):
            assert _pick_u_tile(U, cap) == jfd._pick_u_tile(U, cap), (U, cap)


@pytest.mark.parametrize("layout", ["plain", "beam", "folded"])
@pytest.mark.parametrize("max_len", [5, 40, 77, 120])
def test_init_kv_cache_tile_major_shapes_match_jax(monkeypatch, layout, max_len):
    jcfg, cfg = jgpt2.GPT2Config(**TINY), gpt2.GPT2Config(**TINY)
    kw = {"plain": {}, "beam": dict(beam_size=5),
          "folded": dict(beam_size=5, prefix_slots=10)}[layout]
    want = jgpt2.init_kv_cache(jcfg, 15, max_len, dtype=jnp.float32, tile_major=True, **kw)
    got = gpt2.init_kv_cache(cfg, 15, max_len, dtype=torch.float32, tile_major=True, **kw)
    assert len(got) == len(want) == TINY["n_layer"]
    assert got[0].dim() == 5 and tuple(got[0].shape) == want[0].shape
    assert gpt2._cache_slots(got[0]) == jgpt2._tm_slots(want[0])
    # The env default, and int8 staying strided as in the JAX package.
    monkeypatch.setenv("CLIPCAP_CACHE_TILE_MAJOR", "1")
    assert tuple(gpt2.init_kv_cache(cfg, 15, max_len, dtype=torch.float32, **kw)[0].shape) \
        == want[0].shape
    i8 = gpt2.init_kv_cache(cfg, 15, max_len, int8=True, **kw)[0]
    j8 = jgpt2.init_kv_cache(jcfg, 15, max_len, int8=True, tile_major=True, **kw)[0]
    assert tuple(i8[0].shape) == j8[0].shape and i8[0].dim() == 4
    monkeypatch.setenv("CLIPCAP_CACHE_TILE_MAJOR", "0")
    assert gpt2.init_kv_cache(cfg, 15, max_len, dtype=torch.float32, **kw)[0].dim() == 4


# ---------------------------------------------------------------------------
# One decode-attention call: the twin on a 5-D cache against the Pallas
# manual-pipeline kernel
# ---------------------------------------------------------------------------


def test_twin_on_tile_major_matches_jax_manual_kernel():
    """At every u_valid boundary of two 96-slot tiles, with a broadcast and
    a per-row (ancestry-shaped) mask, on both cache layouts."""
    rng = np.random.default_rng(11)
    R, H, K, Dh, U, ut = 4, 3, 5, 64, 192, 96
    q = rng.normal(size=(R, H, K, Dh)).astype(np.float32)
    kv = rng.normal(size=(R, H, U, 2 * Dh)).astype(np.float32)
    kv5 = _to_tile_major(kv, ut)
    cases = []
    for u_valid in (1, 95, 96, 97, 191, 192):
        vis = np.zeros((1, K, U), np.float32)
        vis[:, :, u_valid:] = NEG_INF
        cases.append((u_valid, vis))
    # Per row: the JAX kernel reads whole tiles, so the mask hides the
    # slots past u_valid, as the decode loops' masks do.
    vis = (rng.normal(size=(R, K, U)) > 0.4).astype(np.float32) * NEG_INF
    vis[:, :, 0] = 0.0
    vis[:, :, 150:] = NEG_INF
    cases.append((150, vis))
    for u_valid, mask in cases:
        for form, kvx in (("strided", kv), ("tile-major", kv5)):
            want = jfd.flash_decode(jnp.asarray(q), jnp.asarray(kvx), jnp.asarray(mask),
                                    u_valid=jnp.int32(u_valid), manual=True, interpret=True)
            got = flash_decode(_t(q), _t(kvx), _t(mask), u_valid, manual=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5,
                                       err_msg=f"{form} u_valid={u_valid} Rm={len(mask)}")


def test_twin_on_tile_major_sampling_shape():
    """K = 1 over an 80-slot u-tile (the sampling cache's single tile
    under the default cap), two tiles."""
    rng = np.random.default_rng(13)
    R, H, K, Dh, U, ut = 6, 4, 1, 64, 160, 80
    q = rng.normal(size=(R, H, K, Dh)).astype(np.float32)
    kv5 = _to_tile_major(rng.normal(size=(R, H, U, 2 * Dh)).astype(np.float32), ut)
    for uv in (1, 79, 80, 81, 160):
        vis = np.zeros((1, K, U), np.float32)
        vis[:, :, uv:] = NEG_INF
        want = jfd.flash_decode(jnp.asarray(q), jnp.asarray(kv5), jnp.asarray(vis),
                                u_valid=jnp.int32(uv), manual=True, interpret=True)
        got = flash_decode(_t(q), _t(kv5), _t(vis), uv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5,
                                   err_msg=str(uv))


def test_tile_major_rejects_int8_and_carry():
    q = torch.zeros(2, 3, 5, 64)
    kv5 = torch.zeros(2, 2, 3, 96, 128)
    mask = torch.zeros(1, 5, 192)
    scales = (torch.ones(2, 3, 192), torch.ones(2, 3, 192))
    with pytest.raises(ValueError, match="tile-major"):
        flash_decode(q, kv5, mask, 10, scales=scales)
    with pytest.raises(ValueError, match="tile-major"):
        flash_decode(q, kv5, mask, 10, return_carry=True)
    with pytest.raises(ValueError, match="tile-major"):
        flash_decode_ref(q, kv5, mask, 10, carry=fd._fresh(q))


# ---------------------------------------------------------------------------
# The cache after prefill and 40 beam steps, and the decode loops
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_lm():
    params = jgpt2.init_gpt2(jgpt2.GPT2Config(**TINY))
    model = convert.gpt2_from_params(jax.tree_util.tree_map(np.asarray, params),
                                     gpt2.GPT2Config(**TINY))
    prefix = np.random.default_rng(5).normal(size=(4, 4, 64)).astype(np.float32) * 0.02
    return params, model, prefix


def test_tile_major_cache_after_prefill_and_40_steps_equals_jax(tiny_lm):
    """Folded-prefix beam cache (P = 4, K = 5: 204 slots over 64-slot
    tiles, so step writes of 5 slots straddle tiles): after the prefill
    and 40 decode steps the port's 5-D buffers hold what JAX's hold, read
    through ``_tm_logical``."""
    params, model, prefix = tiny_lm
    jcfg = jgpt2.GPT2Config(**TINY)
    R, P, K, N = 4, 4, 5, 40
    B = R * K
    rng = np.random.default_rng(7)
    steps = (rng.normal(size=(N, B, 1, 64)) * 0.02).astype(np.float32)
    anc = np.tile(np.arange(K, dtype=np.int32)[:, None], (R, N)).reshape(B, N)
    anc = np.ascontiguousarray(anc)

    jcache = jgpt2.init_kv_cache(jcfg, B, N, dtype=jnp.float32, beam_size=K, prefix_slots=P,
                                 tile_major=True)
    _, jcache = jgpt2.gpt2_apply(params, jcfg, inputs_embeds=jnp.asarray(prefix),
                                 kv_cache=jcache, cache_index=jnp.int32(0), dtype=jnp.float32,
                                 flash=False)

    @jax.jit
    def jstep(cache, x, i):
        return jgpt2.gpt2_apply(params, jcfg, inputs_embeds=x, kv_cache=cache, cache_index=i,
                                dtype=jnp.float32, beam_size=K, ancestry=jnp.asarray(anc),
                                cache_base=P, flash=False)

    cache = gpt2.init_kv_cache(model.config, B, N, dtype=torch.float32, beam_size=K,
                               prefix_slots=P, tile_major=True)
    _, cache = gpt2.gpt2_apply(model, inputs_embeds=_t(prefix), kv_cache=cache, cache_index=0)
    for i in range(N):
        jout, jcache = jstep(jcache, jnp.asarray(steps[i]), jnp.int32(P + i))
        out, cache = gpt2.gpt2_apply(model, inputs_embeds=_t(steps[i]), kv_cache=cache,
                                     cache_index=P + i, beam_size=K, ancestry=_t(anc),
                                     cache_base=P)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4, rtol=1e-4)
    assert cache[0].shape == (R, 256 // 64, TINY["n_head"], 64, 2 * 16)   # 256 slots, u = 64
    for got, want in zip(cache, jcache):
        np.testing.assert_allclose(fd._logical(got).numpy(), np.asarray(jgpt2._tm_logical(want)),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("fold_prefix", [True, False])
def test_beam_tokens_tile_major_equal_strided_and_jax(tiny_lm, fold_prefix):
    """Beam 5, 40 new tokens (stop token outside the vocabulary, so every
    step runs and the writes straddle u-tiles)."""
    params, model, prefix = tiny_lm
    base = dict(beam_size=5, max_new_tokens=40, stop_token=2111, fold_prefix=fold_prefix)
    want = jbeam_search_batched(params, jgpt2.GPT2Config(**TINY), jnp.asarray(prefix),
                                JBeamParams(**base, tile_major=False), dtype=jnp.float32,
                                flash=False)
    runs = {tm: beam_search_batched(model, _t(prefix), BeamParams(**base, tile_major=tm),
                                    dtype=torch.float32) for tm in (False, True)}
    for tm, got in runs.items():
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens),
                                      err_msg=f"tile_major={tm}")
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-4)
    assert torch.equal(runs[True].tokens, runs[False].tokens)


def test_sampling_tokens_tile_major_equal_strided_and_jax(tiny_lm, monkeypatch):
    """Greedy sampling, 40 new tokens; the env default takes the same path
    as ``tile_major=True``."""
    params, model, prefix = tiny_lm
    kw = dict(max_new_tokens=40, mode="greedy", stop_token=2111)
    want = jengine.decode(params, jgpt2.GPT2Config(**TINY), jnp.asarray(prefix),
                          jax.random.PRNGKey(0), jengine.SamplingParams(**kw, tile_major=False),
                          dtype=jnp.float32, flash=False)
    sp = engine.SamplingParams(**kw)
    got = {tm: engine.decode(model, _t(prefix), torch.Generator().manual_seed(0),
                             dataclasses.replace(sp, tile_major=tm), dtype=torch.float32)
           for tm in (False, True)}
    monkeypatch.setenv("CLIPCAP_CACHE_TILE_MAJOR", "1")
    got["env"] = engine.decode(model, _t(prefix), torch.Generator().manual_seed(0), sp,
                               dtype=torch.float32)
    for key, res in got.items():
        np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(want.tokens),
                                      err_msg=str(key))


def test_consolidation_keeps_the_cache_strided(tiny_lm, monkeypatch):
    """Under ``consolidate_every`` the beam cache is pinned strided, as in
    the JAX package; a tile-major cache refuses consolidation."""
    _, model, prefix = tiny_lm
    monkeypatch.setenv("CLIPCAP_CACHE_TILE_MAJOR", "1")
    bp = dict(beam_size=3, max_new_tokens=8, stop_token=2111, consolidate_every=2)
    got = beam_search_batched(model, _t(prefix), BeamParams(**bp, tile_major=True),
                              dtype=torch.float32)
    ref = beam_search_batched(model, _t(prefix), BeamParams(**bp, tile_major=False),
                              dtype=torch.float32)
    assert torch.equal(got.tokens, ref.tokens)
    live = gpt2.init_kv_cache(model.config, 12, 8, dtype=torch.float32, beam_size=3,
                              tile_major=True)
    shared = gpt2.init_shared_kv(model.config, 4, 12, dtype=torch.float32)
    with pytest.raises(ValueError, match="tile-major"):
        gpt2.consolidate_kv_cache(live, shared, torch.zeros(4, 8, dtype=torch.long), 3, base=4)


# ---------------------------------------------------------------------------
# The kernels against the twin (on the card only)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# fp32: another summation order (1e-4 abs); bf16: the twin rounds the
# softmax weights to bf16 and the kernels keep them fp32 (2e-2 abs).
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _cuda_case(g, R, H, K, U, ut, dtype, dev):
    q = torch.randn(R, H, K, 64, generator=g, device=dev).to(dtype)
    kv = torch.randn(R, H, U, 128, generator=g, device=dev).to(dtype)
    kv5 = kv.reshape(R, H, U // ut, ut, 128).permute(0, 2, 1, 3, 4).contiguous()
    mask = torch.where(torch.rand(R, K, U, generator=g, device=dev) < 0.5, 0.0, NEG_INF)
    mask[..., 0] = 0.0
    return q, kv, kv5, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slots", ["2", "3", "4"])
@pytest.mark.parametrize("K,U,ut", [(5, 384, 64), (1, 80, 80), (5, 192, 96)])
def test_manual_kernel_matches_twin(cuda, monkeypatch, dtype, slots, K, U, ut):
    monkeypatch.setenv("CLIPCAP_FLASH_MANUAL_SLOTS", slots)
    g = torch.Generator(device=cuda).manual_seed(K + U)
    q, kv, kv5, mask = _cuda_case(g, 6, 3, K, U, ut, dtype, cuda)
    lo = torch.tensor([0, 7, 63, 64, 65, 1], dtype=torch.int32, device=cuda)
    hi = torch.tensor([1, 70, 64, U, U - 1, U // 2], dtype=torch.int32, device=cuda)
    before = (flash_decode.launches, flash_decode.manual_launches)
    n = 0
    for bounds in ((0, 1), (0, 63), (0, 64), (0, 65), (17, U - 3), (0, U), (lo, hi)):
        for kvx in (kv, kv5):
            got = flash_decode(q, kvx, mask, bounds[1], u_lo=bounds[0], manual=True)
            want = flash_decode_ref(q, kvx, mask, bounds[1], u_lo=bounds[0])
            torch.testing.assert_close(got.float(), want.float(), atol=KERNEL_TOL[dtype],
                                       rtol=0)
            n += 1
    assert (flash_decode.launches, flash_decode.manual_launches) == (before[0] + n,
                                                                     before[1] + n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_auto_kernel_tile_major_matches_twin(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, kv, kv5, mask = _cuda_case(g, 6, 3, 5, 240, 80, dtype, cuda)
    before = flash_decode.manual_launches
    for lo, hi in ((0, 1), (0, 79), (0, 81), (30, 200), (0, 240)):
        got = flash_decode(q, kv5, mask, hi, u_lo=lo, manual=False)
        want = flash_decode_ref(q, kv, mask, hi, u_lo=lo)
        torch.testing.assert_close(got.float(), want.float(), atol=KERNEL_TOL[dtype], rtol=0)
    assert flash_decode.manual_launches == before


@pytest.mark.cuda
def test_int8_and_carry_take_the_auto_kernel(cuda, monkeypatch):
    """``manual`` applies to a bf16/fp32 cache with no carry: the int8
    and carry forms launch the auto kernel, and the env switch reaches the
    manual one at each call."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q, kv, _, mask = _cuda_case(g, 4, 3, 5, 256, 64, torch.float32, cuda)
    rows = torch.randint(-127, 128, (4, 3, 256, 128), generator=g, device=cuda).to(torch.int8)
    scales = tuple(torch.rand(4, 3, 256, generator=g, device=cuda) * 0.01 + 0.005
                   for _ in range(2))
    counts = lambda: (flash_decode.launches, flash_decode.manual_launches,  # noqa: E731
                      flash_decode.int8_launches)
    c0 = counts()
    got = flash_decode(q, rows, mask, 200, scales=scales, manual=True)
    torch.testing.assert_close(got, flash_decode_ref(q, rows, mask, 200, scales=scales),
                               atol=1e-4, rtol=0)
    part = flash_decode(q, kv, mask, 100, return_carry=True, manual=True)
    two = flash_decode(q, kv, mask, 256, u_lo=100, carry=part, manual=True)
    torch.testing.assert_close(two, flash_decode_ref(q, kv, mask, 256), atol=1e-4, rtol=0)
    assert counts() == (c0[0] + 3, c0[1], c0[2] + 1)
    monkeypatch.setenv("CLIPCAP_FLASH_MANUAL", "1")
    flash_decode(q, kv, mask, 256)
    assert counts() == (c0[0] + 4, c0[1] + 1, c0[2] + 1)
    monkeypatch.setenv("CLIPCAP_FLASH_MANUAL_SLOTS", "5")
    with pytest.raises(ValueError, match="2 to 4"):
        flash_decode(q, kv, mask, 256)
