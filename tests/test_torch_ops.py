"""The port's ops (clipcap_tpu_torch.ops) against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  Where the
JAX function is a Pallas kernel it runs in interpret mode on the CPU, as
the JAX package's own tests run it; the port's side is the kernel's plain
twin, which is what a CPU tensor reaches.  Tolerances are fp32: both sides
compute the same fp32 arithmetic in another summation order, so they
agree to a few ulps of O(1) values (1e-5 abs), or 1e-4 where a 64-long dot
product feeds an exp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clipcap_tpu.ops import attention as jattn
from clipcap_tpu.ops import layers as jlayers
from clipcap_tpu.ops import sampling as jsampling
from clipcap_tpu.ops.flash_decode import flash_decode as jflash_decode
from clipcap_tpu_torch.models.decoding import NEG_INF, beam_mask
from clipcap_tpu_torch.ops import attention, layers, sampling
from clipcap_tpu_torch.ops.flash_decode import flash_decode, flash_decode_ref

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _visible_mask(rng, Rm, K, U, u_valid):
    """Random visible pattern over [0, u_valid) with slot 0 always visible;
    slots past u_valid hidden (the contract the JAX kernel relies on)."""
    vis = rng.random((Rm, K, U)) < 0.6
    vis[..., 0] = True
    vis[..., u_valid:] = False
    return np.where(vis, 0.0, NEG_INF).astype(np.float32)


@pytest.mark.parametrize("K,Rm,U", [(1, 1, 80), (1, 3, 80), (5, 3, 384), (5, 1, 64)])
def test_flash_decode_ref_matches_pallas(K, Rm, U):
    rng = np.random.default_rng(K * 10 + Rm)
    R, H, Dh = 3, 2, 64
    q = rng.standard_normal((R, H, K, Dh)).astype(np.float32)
    kv = rng.standard_normal((R, H, U, 2 * Dh)).astype(np.float32)
    for u_valid in sorted({1, 17, U // 2 + 3, U}):
        mask = _visible_mask(rng, Rm, K, U, u_valid)
        want = jflash_decode(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(mask),
                             u_valid=u_valid, interpret=True)
        got = flash_decode_ref(_t(q), _t(kv), _t(mask), u_valid)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5,
                                   err_msg=f"u_valid={u_valid}")


def test_flash_decode_beam_ancestry_mask_matches_pallas():
    """The folded-prefix beam mask of a mid-decode step (the port's own
    builder) through both attention forms."""
    rng = np.random.default_rng(7)
    R, K, H, Dh, P, N = 2, 5, 2, 64, 10, 67
    U = 384                                      # the folded beam cache's slots
    step = 30
    ancestry = torch.from_numpy(rng.integers(0, K, (R * K, N)))
    mask = beam_mask(ancestry, K, U, offset=P + step, cache_base=P).numpy()
    u_valid = P + (step + 1) * K
    q = rng.standard_normal((R, H, K, Dh)).astype(np.float32)
    kv = rng.standard_normal((R, H, U, 2 * Dh)).astype(np.float32)
    want = jflash_decode(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(mask),
                         u_valid=u_valid, interpret=True)
    got = flash_decode_ref(_t(q), _t(kv), _t(mask), u_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_flash_decode_wrapper_takes_twin_on_cpu():
    rng = np.random.default_rng(0)
    q = _t(rng.standard_normal((2, 2, 1, 64)).astype(np.float32))
    kv = _t(rng.standard_normal((2, 2, 32, 128)).astype(np.float32))
    mask = torch.zeros(1, 1, 32)
    before = flash_decode.launches
    torch.testing.assert_close(flash_decode(q, kv, mask, 20), flash_decode_ref(q, kv, mask, 20),
                               rtol=0, atol=0)
    assert flash_decode.launches == before        # the count is of kernel launches


@pytest.mark.parametrize("form,heads,Dh", [("stripe", 2, 64), ("row", 1, 64), ("row", 3, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_packed_ref_matches_pallas(form, heads, Dh, causal):
    """Both Pallas forms: the stripe kernel takes D % 128 == 0, the
    whole-row kernel the rest."""
    D = heads * Dh
    assert (D % 128 == 0) == (form == "stripe")
    rng = np.random.default_rng(heads)
    qkv = rng.standard_normal((2, 50, 3 * D)).astype(np.float32)
    want = jattn.sdpa_packed(jnp.asarray(qkv), heads, causal=causal)
    before = attention.sdpa_packed.launches
    got = attention.sdpa_packed(_t(qkv), heads, causal=causal)
    assert attention.sdpa_packed.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("N", [1, 65, 257])
@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_packed_ref_matches_pallas_at_tail_rows(N, causal):
    """Rows the CUDA kernel splits into a 64-row tile and a tail (65: one
    row past a tile, 257: ViT-L/14's rows, 1: a lone row), 2 heads of 64
    (the stripe form), against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(N)
    qkv = rng.standard_normal((1, N, 3 * 2 * 64)).astype(np.float32)
    want = jattn.sdpa_packed(jnp.asarray(qkv), 2, causal=causal)
    got = attention.sdpa_packed(_t(qkv), 2, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_sdpa_unfused_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 9, 3, 16)).astype(np.float32) for _ in range(3))
    bias = (rng.standard_normal((2, 3, 9, 9)) * 0.5).astype(np.float32)
    for kw in ({"causal": True}, {"bias": bias}):
        want = jattn.sdpa(*map(jnp.asarray, (q, k, v)), fused=False,
                          **{n: jnp.asarray(a) if n == "bias" else a for n, a in kw.items()})
        got = attention.sdpa(_t(q), _t(k), _t(v), fused=False,
                             **{n: _t(a) if n == "bias" else a for n, a in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_layers_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    scale, bias = rng.standard_normal((2, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    pairs = [
        (layers.layer_norm(_t(x), _t(scale), _t(bias)),
         jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))),
        (layers.linear(_t(x), _t(w), _t(b)), jlayers.linear(jnp.asarray(x), jnp.asarray(w),
                                                            jnp.asarray(b))),
    ]
    pairs += [(layers.ACTIVATIONS[n](_t(x)), jlayers.ACTIVATIONS[n](jnp.asarray(x)))
              for n in ("gelu_new", "quick_gelu", "gelu", "relu")]
    table = rng.standard_normal((11, 4)).astype(np.float32)
    ids = rng.integers(0, 11, (2, 6))
    pairs.append((layers.embed(_t(table), _t(ids), torch.float32),
                  jlayers.embed(jnp.asarray(table), jnp.asarray(ids), jnp.float32)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def _layer_norm_formula(x, scale, bias, eps=1e-5):
    """The plain fp32 layer norm, op by op (the JAX package's formula)."""
    orig = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(orig)


def _bf16(t):
    """A bf16 torch tensor as a bf16 JAX array, value for value."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _within_one_bf16_ulp(got, want):
    """Each element of bf16 ``got`` within one bf16 ulp of ``want`` (floored
    at 2^-20 near zero, where the O(1) terms cancel: a few fp32 ulps of them
    before the rounding)."""
    assert got.dtype == torch.bfloat16
    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -13))) - 7)
    assert bool(((got.float() - want).abs() <= ulp).all())


@pytest.mark.parametrize("case", ["bf16_weights", "fp32_weights", "fp32_grads",
                                  "bf16_x_fp32_weights_grads"])
@pytest.mark.parametrize("D", [768, 1024, 1600, 2048])
def test_layer_norm_is_the_fp32_formula(D, case):
    """bf16 ``x`` with bf16 or fp32 weights: within one bf16 ulp of the JAX
    package's ``layer_norm`` on the same bf16 inputs.  fp32: the gradients of
    ``x``, ``scale`` and ``bias`` those of the plain formula.  bf16 ``x`` with
    fp32 weights (train's bf16 compute over fp32 norms): the gradients those
    of the JAX function under ``jax.vjp``, ``x``'s within one bf16 ulp."""
    g = torch.Generator().manual_seed(D)
    x = torch.randn(4, 37, D, generator=g) * 3 + 0.5
    scale = torch.randn(D, generator=g) * 0.2 + 1
    bias = torch.randn(D, generator=g) * 0.2
    up = torch.randn(4, 37, D, generator=g)
    if case == "fp32_grads":
        grads = []
        for fn in (layers.layer_norm, _layer_norm_formula):
            leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
            (fn(*leaves) * up).sum().backward()
            grads.append([t.grad for t in leaves])
        for got, want in zip(*grads):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)
        return
    x = x.bfloat16()
    if case == "bf16_x_fp32_weights_grads":
        up = up.bfloat16()
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        y = layers.layer_norm(*leaves)
        assert y.dtype == torch.bfloat16
        y.backward(up)
        _, vjp = jax.vjp(jlayers.layer_norm, _bf16(x), jnp.asarray(scale.numpy()),
                         jnp.asarray(bias.numpy()))
        dx, dscale, dbias = vjp(_bf16(up))
        _within_one_bf16_ulp(leaves[0].grad, _t(dx.astype(jnp.float32)))
        for got, want in ((leaves[1].grad, dscale), (leaves[2].grad, dbias)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)
        return
    if case == "bf16_weights":
        scale, bias = scale.bfloat16(), bias.bfloat16()
    got = layers.layer_norm(x, scale, bias)
    want = jlayers.layer_norm(_bf16(x), _bf16(scale) if case == "bf16_weights"
                              else jnp.asarray(scale.numpy()),
                              _bf16(bias) if case == "bf16_weights" else jnp.asarray(bias.numpy()))
    assert want.dtype == jnp.bfloat16
    _within_one_bf16_ulp(got, _t(want.astype(jnp.float32)))


def test_initializers_draw_as_jax():
    """Seeded weights are the JAX package's draws, bit for bit."""
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(layers.normal_init(a, (3, 4), 0.5),
                                  np.asarray(jlayers.normal_init(b, (3, 4), 0.5)))
    for got, want in zip(layers.torch_linear_init(a, 6, 3), jlayers.torch_linear_init(b, 6, 3)):
        np.testing.assert_array_equal(got, np.asarray(want))


def _jitted_sampling():
    """The JAX processors, jitted (op-by-op dispatch is several times slower)."""
    import types

    import jax

    static = {"top_k_top_p_filter": (1, 2), "repetition_penalty_apply": (2,),
              "sentence_length_penalty_apply": (1, 3, 4), "nucleus_renormalize": (1, 2)}
    return types.SimpleNamespace(**{n: jax.jit(getattr(jsampling, n), static_argnums=a)
                                    for n, a in static.items()})


def test_sampling_processors_match_jax():
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((4, 300)) * 3).astype(np.float32)
    tokens = rng.integers(0, 300, (4, 7))
    valid = rng.random((4, 7)) < 0.7
    jl, tl = jnp.asarray(logits), _t(logits)
    jsampling = _jitted_sampling()
    cases = [
        (sampling.top_k_top_p_filter(tl, 10, 0.0), jsampling.top_k_top_p_filter(jl, 10, 0.0)),
        (sampling.top_k_top_p_filter(tl, 0, 0.7), jsampling.top_k_top_p_filter(jl, 0, 0.7)),
        (sampling.top_k_top_p_filter(tl, 40, 0.9), jsampling.top_k_top_p_filter(jl, 40, 0.9)),
        (sampling.repetition_penalty_apply(tl, _t(tokens), 1.2, _t(valid)),
         jsampling.repetition_penalty_apply(jl, jnp.asarray(tokens), 1.2, jnp.asarray(valid))),
        (sampling.sentence_length_penalty_apply(tl, 13, 7, 50, 1.0),
         jsampling.sentence_length_penalty_apply(jl, 13, jnp.asarray(7), 50, 1.0)),
        (sampling.nucleus_renormalize(tl, 0, 0.8), jsampling.nucleus_renormalize(jl, 0, 0.8)),
        (sampling.nucleus_renormalize(tl, 5, 0.95), jsampling.nucleus_renormalize(jl, 5, 0.95)),
    ]
    for i, (got, want) in enumerate(cases):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5,
                                   err_msg=f"case {i}")


def test_samplers_draw_from_the_nucleus():
    """Sampled tokens come from the kept window; a one-candidate nucleus
    is the argmax, whatever the generator."""
    rng = np.random.default_rng(4)
    logits = _t((rng.standard_normal((64, 500)) * 3).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert (sampling.nucleus_sample(g, logits, 5, 1.0)[:, None] == top5).any(-1).all()
    filtered = sampling.top_k_top_p_filter(logits, 5, 0.0)
    assert (sampling.filtered_sample(g, filtered, 5)[:, None] == top5).any(-1).all()
    torch.testing.assert_close(sampling.nucleus_sample(g, logits, 1, 0.8), logits.argmax(-1))
