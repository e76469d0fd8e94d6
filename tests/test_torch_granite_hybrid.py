"""Granite-4.0-H as the captioner's language model (``models/granite_hybrid.py``).

At the tiny preset ``granite-hybrid-test`` (hidden 64; Mamba layers 0, 2, 3
of 4 with 8 heads of 16 and a state of 16; one GQA layer, 4 query heads
over 2 K|V heads; 8 experts top-3, softmax routing, a shared MLP;
vocabulary 512; seeded), on the CPU, in float32: the port against the
benchmark's plain reference (``portbench/reference/granite_hybrid.py``),
which runs each sequence from position 0 with no cache, and against the
installed ``transformers``' ``GraniteMoeHybridForCausalLM``.  Tolerances:
2e-5 of the logits' scale for float32 against float32 (summation order
only: the reference runs the recurrence in its own order, the port its
kernel's twin, the grouped experts and the K|V cache); 1e-4 of the
logits' scale against ``transformers``, whose Mamba layer runs the chunked
(SSD) form of the recurrence, exponentials of cumulative sums in another
order; 1e-5 absolute for the Mamba step's outputs, of order 0.1 (the twin
and the recurrence differ in summation order).

The tests marked ``cuda`` hold the Mamba kernel to its twin at the
published widths and graphed beam search to the same segments run
eagerly; this file imports no JAX, so on the card: ``python -m pytest
tests/test_torch_granite_hybrid.py --noconftest -m cuda -q``.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
from clipcap_tpu_torch.models import deepseek_v2 as dsv2
from clipcap_tpu_torch.models import granite_hybrid as gh
from clipcap_tpu_torch.models.decoding import beam_mask, beam_parent
from clipcap_tpu_torch.models.granite_hybrid import (GRANITE_PRESETS, granite_apply,
                                                     granite_embed_tokens, init_granite,
                                                     init_granite_cache)
from clipcap_tpu_torch.ops import gqa, mamba

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.reference import granite_hybrid as ref  # noqa: E402
from portbench.reference.numerics import Numerics  # noqa: E402

CFG = GRANITE_PRESETS["granite-hybrid-test"]
NEVER = -1      # a stop token no step emits


def _ref_cfg(cfg) -> dict:
    """The reference's dict of config keys for a port config."""
    c = dataclasses.asdict(cfg)
    c["experts_held"] = list(cfg.experts_held)
    return c


@pytest.fixture(scope="module")
def lm():
    return init_granite(CFG, seed=5)


def _ref_logits(lm, embeds):
    W = lm.state_dict()
    num = Numerics("fp32")
    c = _ref_cfg(lm.config)
    return ref.lm_logits(W, ref.granite_hidden(W, embeds, c, num), num, c)


def _close(got, want, tol=2e-5):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale, float((got - want).abs().max())


@pytest.mark.parametrize("held", [(0, 8), (3, 6)], ids=["all_experts", "a_share"])
def test_forward_matches_reference(held):
    lm = init_granite(dataclasses.replace(CFG, experts_held=held), seed=5)
    x = torch.randn(3, 9, CFG.hidden_size, generator=torch.Generator().manual_seed(0))
    logits, _ = granite_apply(lm, inputs_embeds=x)
    _close(logits, _ref_logits(lm, x))


# -- the Mamba step ----------------------------------------------------------

H, P, N = 2, 16, 8
C = H * P + 2 * N


def _recurrence(xs, dts, w, b, A_log, D, dt_bias):
    """The Mamba-2 mixer's arithmetic over one row's history from position
    0: ``xs`` [T, C] inputs before the convolution, ``dts`` [T, H] → the
    last position's y [H·P]."""
    T = xs.shape[0]
    pad = torch.cat([torch.zeros(3, C), xs])
    S = torch.zeros(H, P, N)
    for t in range(T):
        y = F.silu((pad[t:t + 4] * w.t()).sum(0) + b)
        x, Bm, Cm = y[:H * P].view(H, P), y[H * P:H * P + N], y[H * P + N:]
        dt = F.softplus(dts[t] + dt_bias)
        S = S * torch.exp(-dt * A_log.exp())[:, None, None] + (dt[:, None] * x)[..., None] * Bm
        out = torch.einsum("hpn,n->hp", S, Cm) + D[:, None] * x
    return out.reshape(-1)


# Each step's parents of 6 rows (2 samples × 3 beams): random, repeated, all
# on one row, the identity.
PARENTS = [[-1] * 6, [2, 0, 1, 5, 5, 3], [1, 1, 1, 4, 4, 4], [0, 0, 0, 0, 0, 0],
           [0, 1, 2, 3, 4, 5], [2, 2, 0, 3, 5, 4]]


def test_mamba_twin_matches_the_recurrence_over_each_rows_history():
    g = torch.Generator().manual_seed(11)
    B = 6
    w = torch.rand(C, 4, generator=g) - 0.5
    b = torch.rand(C, generator=g) - 0.5
    A_log = torch.rand(H, generator=g).mul(15).add(1).log()
    D = torch.rand(H, generator=g) + 0.5
    dt_bias = torch.randn(H, generator=g) - 2
    windows = [torch.full((B, 3, C), float("nan")) for _ in range(2)]
    states = [torch.full((B, H, P, N), float("nan")) for _ in range(2)]
    history = [[] for _ in range(B)]
    for t, parents in enumerate(PARENTS):
        xbc = torch.randn(B, C, generator=g)
        dt = torch.randn(B, H, generator=g)
        parent = torch.tensor(parents, dtype=torch.int32)
        y = mamba.mamba_decode(xbc, dt, w[:, None], b, A_log, D, dt_bias, parent,
                               windows[t % 2], windows[(t + 1) % 2], states[t % 2],
                               states[(t + 1) % 2], 3)
        history = [(history[p] if p >= 0 else []) + [(xbc[r], dt[r])]
                   for r, p in enumerate(parents)]
        for r in range(B):
            xs, dts = (torch.stack(z) for z in zip(*history[r]))
            want = _recurrence(xs, dts, w, b, A_log, D, dt_bias)
            torch.testing.assert_close(y[r], want, rtol=0, atol=1e-5)


def test_gqa_decode_matches_plain_attention():
    """Each query head reads its group's K|V head through the beam mask."""
    g = torch.Generator().manual_seed(3)
    R, K, Hq, Hkv, Dh, slots = 2, 3, 4, 2, 8, 16
    q = torch.randn(R, K, Hq, Dh, generator=g)
    cache = torch.randn(R, slots, 2 * Hkv * Dh, generator=g)
    ancestry = torch.randint(0, K, (R * K, 3), generator=g)
    mask = beam_mask(ancestry, K, slots, 6, cache_base=4)
    got = gqa.gqa_decode(q, cache, mask, 13, 0.3, Hkv)
    kv = cache[:, :13].view(R, 13, 2, Hkv, Dh)
    for r in range(R):
        for k in range(K):
            for h in range(Hq):
                keys, vals = kv[r, :, 0, h // 2], kv[r, :, 1, h // 2]
                w = torch.softmax(keys @ q[r, k, h] * 0.3 + mask[r, k, :13], dim=-1)
                torch.testing.assert_close(got[r, k, h * Dh:(h + 1) * Dh], w @ vals)


# -- prefill and beam decode through the hybrid cache ------------------------


def _beam_run(lm, g, reorders):
    """Prefill the folded prefix, then beam decode steps, the beams
    reordered by ``reorders[step]`` [R, K] after each step; yields each
    step's logits beside the reference's over each beam's own history."""
    R, K, P, N = 2, 3, 4, len(reorders) + 1
    B = R * K
    prefix = torch.randn(R, P, CFG.hidden_size, generator=g)
    cache = init_granite_cache(CFG, B, N, dtype=torch.float32, beam_size=K, prefix_slots=P)
    granite_apply(lm, inputs_embeds=prefix, kv_cache=cache, cache_index=0, return_logits=False)
    own = torch.arange(B) % K
    ancestry = own[:, None].repeat(1, N)
    history = [[] for _ in range(B)]
    for step in range(1, N):
        pos = P + step - 1
        ancestry[:, pos - P] = own
        tok = torch.randint(0, CFG.vocab_size, (B,), generator=g)
        for b in range(B):
            history[b].append(int(tok[b]))
        logits, _ = granite_apply(lm, inputs_embeds=granite_embed_tokens(lm, tok[:, None]),
                                  kv_cache=cache, cache_index=pos, beam_size=K,
                                  ancestry=ancestry, cache_base=P)
        for b in range(B):
            x = torch.cat([prefix[b // K], granite_embed_tokens(lm, torch.tensor(history[b]))])
            yield logits[b, 0], _ref_logits(lm, x[None])[0, -1]
        if step < N - 1:
            src = reorders[step - 1]
            ancestry = ancestry.reshape(R, K, N).gather(1, src[..., None].expand(R, K, N))
            ancestry = ancestry.reshape(B, N)
            history = [list(history[r * K + int(src[r, k])]) for r in range(R) for k in range(K)]


# Beams swap parents (sample 0 reversed, sample 1 rotated), then random draws.
SWAPS = [torch.tensor([[2, 1, 0], [1, 2, 0]]), torch.tensor([[0, 0, 2], [2, 2, 2]]),
         torch.tensor([[1, 2, 0], [0, 1, 1]]), torch.tensor([[2, 0, 0], [1, 0, 2]])]


def test_prefill_then_beam_decode_matches_reference(lm):
    """Each step's logits equal the reference's full forward over the
    beam's own history, with beams taking other beams' paths."""
    for got, want in _beam_run(lm, torch.Generator().manual_seed(1), SWAPS):
        _close(got, want)


def test_a_missing_reorder_fails_the_comparison(lm, monkeypatch):
    """Each row continuing its own state and window, not its parent's,
    gives other logits once beams have swapped."""
    def own_rows(ancestry, beam_size, cache_index, cache_base):
        parent = beam_parent(ancestry, beam_size, cache_index, cache_base)
        if cache_index == cache_base:
            return parent
        return torch.arange(ancestry.shape[0], dtype=torch.int32)

    monkeypatch.setattr(gh, "beam_parent", own_rows)
    gaps = [float((got - want).abs().max() / want.abs().max())
            for got, want in _beam_run(lm, torch.Generator().manual_seed(1), SWAPS)]
    assert max(gaps) > 1e-2, max(gaps)


# -- the published code, routing and the expert share -------------------------


def _hf_config(transformers):
    return transformers.GraniteMoeHybridConfig(
        vocab_size=CFG.vocab_size, hidden_size=CFG.hidden_size,
        intermediate_size=CFG.intermediate_size,
        shared_intermediate_size=CFG.shared_intermediate_size,
        num_hidden_layers=CFG.num_hidden_layers, num_attention_heads=CFG.num_attention_heads,
        num_key_value_heads=CFG.num_key_value_heads, layer_types=list(CFG.layer_types),
        mamba_n_heads=CFG.mamba_n_heads, mamba_d_head=CFG.mamba_d_head,
        mamba_d_state=CFG.mamba_d_state, mamba_n_groups=1, mamba_d_conv=4, mamba_expand=2,
        mamba_chunk_size=4, num_local_experts=CFG.num_local_experts,
        num_experts_per_tok=CFG.num_experts_per_tok, attention_multiplier=0.0078125 * 8,
        embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=16.0,
        rms_norm_eps=1e-5, position_embedding_type="nope", tie_word_embeddings=True,
        max_position_embeddings=512)


def test_port_and_reference_match_transformers(tmp_path):
    """``load_granite`` over a checkpoint the installed library saves: the
    published keys mapped, every expert held, the tied head; full-forward
    logits agree with ``GraniteMoeHybridForCausalLM`` (its Mamba layer's
    chunked form over several chunks).  A held share takes its slice of the
    stacked expert weights."""
    transformers = pytest.importorskip("transformers")
    hc = _hf_config(transformers)
    torch.manual_seed(0)
    hf = transformers.GraniteMoeHybridForCausalLM(hc).eval()
    src = init_granite(CFG, seed=8)          # Mamba-2's draws for the conv, A_log, dt_bias
    with torch.no_grad():
        for i in (0, 2, 3):
            m, n = hf.model.layers[i].mamba, src.model.layers[i].mamba
            for k in ("A_log", "dt_bias", "D"):
                getattr(m, k).copy_(getattr(n, k))
            m.conv1d.weight.copy_(n.conv1d.weight)
            m.conv1d.bias.copy_(n.conv1d.bias)
    hf.save_pretrained(tmp_path, safe_serialization=True)
    port = gh.load_granite(str(tmp_path))
    assert port.config.experts_held == (0, CFG.num_local_experts)
    assert gh.is_granite(str(tmp_path))
    x = torch.randn(2, 11, CFG.hidden_size, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = hf(inputs_embeds=x).logits
        got, _ = granite_apply(port, inputs_embeds=x)
        reference = _ref_logits(port, x)
    _close(got, want, tol=1e-4)
    _close(reference, want, tol=1e-4)
    share = gh.load_granite(str(tmp_path), experts_held=(2, 5))
    stacked = hf.model.layers[1].block_sparse_moe.input_linear.weight
    assert torch.equal(share.model.layers[1].mlp.experts.gate_up_proj, stacked[2:5])


def test_softmax_routing_matches_the_published_gating():
    """Softmax over all experts, top-k, renormalised: the published softmax
    over the top-k logits."""
    layer = gh._MoE(CFG)
    g = torch.Generator().manual_seed(2)
    layer.gate.weight = torch.nn.Parameter(torch.randn(8, CFG.hidden_size, generator=g),
                                           requires_grad=False)
    h = torch.randn(5, CFG.hidden_size, generator=g)
    w, idx = dsv2._route(layer, h, CFG)
    top, want_idx = torch.topk(h @ layer.gate.weight.t(), 3, dim=-1)
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(w, torch.softmax(top, dim=-1))


def test_expert_shares_add_up_to_the_uncut_layer():
    """Eight chips' shares of 16 experts, 2 each: their partial outputs, the
    shared MLP counted once, add up to the reference's whole layer."""
    whole = dataclasses.replace(CFG, num_local_experts=16, experts_held=(0, 16))
    lm = init_granite(whole, seed=3)
    W = lm.state_dict()
    p = "model.layers.1.mlp."
    h = torch.randn(1, 7, CFG.hidden_size, generator=torch.Generator().manual_seed(4))
    num = Numerics("fp32")
    want = ref._moe(W, p, h, _ref_cfg(whole), num)
    s = p + "shared_experts."
    shared = ref._swiglu(W, s + "input_linear.weight", s + "output_linear.weight",
                         h.reshape(-1, CFG.hidden_size), num).view_as(h)
    total = shared.clone()
    for chip in range(8):
        held = (2 * chip, 2 * chip + 2)
        cfg = dataclasses.replace(whole, experts_held=held)
        layer = gh._MoE(cfg)
        sd = {k[len(p):]: v for k, v in W.items() if k.startswith(p)}
        for n in ("gate_up_proj", "down_proj"):
            sd[f"experts.{n}"] = sd[f"experts.{n}"][held[0]:held[1]]
        layer.load_state_dict(sd, assign=True)
        total += dsv2._moe(layer, h, cfg) - shared
    _close(total, want)


# -- the beam loop and the refusals -------------------------------------------


def test_beam_scores_match_reference_log_probability(lm):
    R, K, P, N = 2, 3, 4, 5
    prefix = torch.randn(R, P, CFG.hidden_size, generator=torch.Generator().manual_seed(6))
    res = beam_search_batched(lm, prefix, BeamParams(beam_size=K, max_new_tokens=N,
                                                     stop_token=NEVER), dtype=torch.float32)
    W = lm.state_dict()
    c = _ref_cfg(CFG)
    for r in range(R):
        for k in range(K):
            t = res.tokens[r, k]
            x = torch.cat([prefix[r], ref.token_embeds(W, t[:-1])])[None]
            h = ref.granite_hidden(W, x, c, Numerics("fp32"))[0, P - 1:]
            logp = torch.log_softmax(ref.lm_logits(W, h, Numerics("fp32"), c), -1)
            want = logp.gather(-1, t[:, None]).mean()
            assert abs(float(res.scores[r, k]) - float(want)) < 1e-5


def test_beam_search_counts_granite_steps(lm):
    before = (beam_search_batched.decode_steps, beam_search_batched.host_syncs,
              mamba.mamba_decode.calls)
    prefix = torch.randn(1, 3, CFG.hidden_size)
    beam_search_batched(lm, prefix, BeamParams(beam_size=2, max_new_tokens=4, stop_token=NEVER),
                        dtype=torch.float32)
    assert beam_search_batched.decode_steps == before[0] + 3
    assert beam_search_batched.host_syncs == before[1] + 3
    # 3 Mamba layers: the prefill's 3 positions, then 3 steps.
    assert mamba.mamba_decode.calls == before[2] + 3 * (3 + 3)


@pytest.mark.parametrize("params", [dict(int8_kv=True), dict(consolidate_every=2),
                                    dict(tile_major=True), dict(fold_prefix=False)],
                         ids=["int8_kv", "consolidated", "tile_major", "replicated_prefix"])
def test_cache_forms_the_hybrid_cache_lacks_raise(lm, params):
    prefix = torch.randn(1, 3, CFG.hidden_size)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, F14"):
        beam_search_batched(lm, prefix, BeamParams(beam_size=2, max_new_tokens=3, **params),
                            dtype=torch.float32)


def test_configs_the_port_lacks_raise():
    hf = dict(dataclasses.asdict(CFG), position_embedding_type="nope", tie_word_embeddings=True)
    assert gh.granite_config_from_hf(hf).experts_held == (0, CFG.num_local_experts)
    with pytest.raises(NotImplementedError, match="rotary attention"):
        gh.granite_config_from_hf(dict(hf, position_embedding_type="rope"))
    with pytest.raises(NotImplementedError, match="more than one Mamba group"):
        gh.granite_config_from_hf(dict(hf, mamba_n_groups=2))
    with pytest.raises(NotImplementedError, match="untied LM head"):
        gh.granite_config_from_hf(dict(hf, tie_word_embeddings=False))


def _clipcap(seed=0):
    from clipcap_tpu_torch.config import Config, EncoderConfig
    from clipcap_tpu_torch.models.clipcap import init_clipcap

    config = Config(language_model="granite-hybrid-test", prefix_length=4, projection_length=4,
                    transformer_layers=2, transformer_attention_heads=4,
                    encoder_config=EncoderConfig(encoder_model_variant="test-tiny",
                                                 encoder_embedding_size=32))
    return config, init_clipcap(config, seed=seed)


def test_clipcap_captions_with_granite_and_refuses_training_and_sampling():
    from clipcap_tpu_torch.inference.engine import SamplingParams, decode
    from clipcap_tpu_torch.models.clipcap import clipcap_loss
    from clipcap_tpu_torch.models.mapper import mapper_apply

    _, model = _clipcap()
    assert isinstance(model.language_model, gh.GraniteHybrid)
    assert model.transformer_mapper.config.lm_embedding_size == CFG.hidden_size
    emb = torch.randn(2, 32, generator=torch.Generator().manual_seed(7))
    prefix = mapper_apply(model.transformer_mapper, emb, dtype=torch.float32)
    res = beam_search_batched(model.language_model, prefix,
                              BeamParams(beam_size=2, max_new_tokens=3, stop_token=NEVER),
                              dtype=torch.float32)
    assert res.tokens.shape == (2, 2, 3) and bool(torch.isfinite(res.scores).all())
    with pytest.raises(NotImplementedError, match="ROADMAP.md, F14"):
        clipcap_loss(model, torch.zeros(2, 3, dtype=torch.long), emb)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, F14"):
        decode(model.language_model, prefix, torch.Generator(), SamplingParams())


def test_decode_graph_keys_follow_the_granite_weights(lm):
    """A key's graphs hold a segment per cut plus one: per layer its Mamba
    step or attention, then its experts."""
    key = (6, 3, torch.bfloat16, torch.device("cuda", 0))    # a key only: nothing runs
    graphs = lm.decode_graphs.get(lm, key)
    assert graphs.segments == 1 + 2 * CFG.num_hidden_layers == len(lm.cuts) + 1
    assert [k for k, _ in lm.cuts] == ["mamba", "moe", "attn", "moe", "mamba", "moe", "mamba",
                                       "moe"]
    lm.model.layers[2].mamba.A_log.data = lm.model.layers[2].mamba.A_log.data.clone()
    assert lm.decode_graphs.get(lm, key) is not graphs


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# Kernel-sized widths: Mamba heads of 64 with a state of 128, D a multiple
# of 128, F of 64.
CARD_CFG = dataclasses.replace(
    CFG, hidden_size=256, intermediate_size=128, shared_intermediate_size=256,
    num_attention_heads=2, num_key_value_heads=1, mamba_n_heads=8, mamba_d_head=64,
    mamba_d_state=128, num_local_experts=16, num_experts_per_tok=4, experts_held=(4, 12),
    vocab_size=1000, name="card")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Mamba kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_mamba_kernel_matches_twin_at_published_widths(cuda, dtype):
    """320 rows (64 samples × 5 beams), 128 heads of 64, a state of 128,
    two steps: parents random, repeated and all five beams on one parent."""
    g = torch.Generator().manual_seed(12)
    R, K, Hh = 64, 5, 128
    B, Cc = R * K, Hh * 64 + 256
    w = (torch.rand(Cc, 1, 4, generator=g) - 0.5).to(cuda, dtype)
    b = (torch.rand(Cc, generator=g) - 0.5).to(cuda, dtype)
    A_log = torch.rand(Hh, generator=g).mul(15).add(1).log().to(cuda, dtype)
    D = torch.ones(Hh).to(cuda, dtype)
    dt_bias = (torch.rand(Hh, generator=g) * -4 - 2).to(cuda, dtype)
    rows = torch.arange(B) // K * K
    parents = [torch.full((B,), -1), rows + torch.randint(0, K, (B,), generator=g)]
    parents[1][:K] = 2                                       # one parent for all five
    win = [torch.randn(B, 3, Cc, generator=g).to(cuda, dtype) for _ in range(2)]
    st = [(torch.randn(B, Hh, 64, 128, generator=g) * 0.1).to(cuda, dtype) for _ in range(2)]
    twin_win = [t.clone() for t in win]
    twin_st = [s.clone() for s in st]
    launches = mamba.mamba_decode.launches
    for t, parent in enumerate(parents):
        zxbcdt = torch.randn(B, 8192 + Cc + Hh, generator=g).to(cuda, dtype)
        xbc, dt = zxbcdt[:, 8192:8192 + Cc], zxbcdt[:, 8192 + Cc:]
        p = parent.to(cuda, torch.int32)
        args = (xbc, dt, w, b, A_log, D, dt_bias, p)
        got = mamba.mamba_decode(*args, win[t % 2], win[(t + 1) % 2], st[t % 2],
                                 st[(t + 1) % 2], K)
        want = mamba.mamba_decode_ref(*args, twin_win[t % 2], twin_win[(t + 1) % 2],
                                      twin_st[t % 2], twin_st[(t + 1) % 2], K)
        torch.cuda.synchronize()
        # fp32 sums over 128 in another order; the output and state rounded to dtype.
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= tol * scale
        torch.testing.assert_close(st[(t + 1) % 2].float(), twin_st[(t + 1) % 2].float(),
                                   rtol=tol, atol=tol * 1e-2)
        assert torch.equal(win[(t + 1) % 2], twin_win[(t + 1) % 2])
    assert mamba.mamba_decode.launches == launches + 2


@pytest.mark.cuda
def test_graphed_granite_beam_search_equals_eager(cuda, monkeypatch):
    """Graphed decode steps give the tokens, lengths and scores of the same
    segments run eagerly, bit for bit (a share of the experts held)."""
    lm = init_granite(CARD_CFG, seed=9).to(cuda, torch.bfloat16)
    prefix = torch.randn(4, 5, CARD_CFG.hidden_size,
                         generator=torch.Generator().manual_seed(10)).to(cuda)
    bp = BeamParams(beam_size=3, max_new_tokens=8, stop_token=NEVER)
    steps = beam_search_batched.graph_steps
    graphed = beam_search_batched(lm, prefix, bp, dtype=torch.bfloat16)
    graphed = beam_search_batched(lm, prefix, bp, dtype=torch.bfloat16)    # replays only
    assert beam_search_batched.graph_steps > steps
    monkeypatch.setattr(beam_mod, "decode_step_graphs", lambda *a, **k: None)
    eager = beam_search_batched(lm, prefix, bp, dtype=torch.bfloat16)
    assert torch.equal(graphed.tokens, eager.tokens)
    assert torch.equal(graphed.seq_lengths, eager.seq_lengths)
    assert torch.equal(graphed.scores, eager.scores)
