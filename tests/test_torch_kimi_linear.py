"""Kimi-Linear as the captioner's language model (``models/kimi_linear.py``).

At the tiny preset ``kimi-linear-test`` (hidden 64; KDA layers 1, 2, 4 of
4 with 2 heads of 16; one MLA layer, 4 heads, latent 32, NoPE; 8 experts
top-3, sigmoid routing, one shared; vocabulary 512; seeded), on the CPU,
in float32: the port against the benchmark's plain reference
(``portbench/reference/kimi_linear.py``), which runs each sequence from
position 0 with no cache.  Tolerances: 2e-5 of the logits' scale for
float32 against float32 (summation order only: the reference runs the
recurrence and attention decompressed, the port its kernel's twin and the
absorbed decode); 1e-5 absolute for the KDA step's outputs, of order 0.1
(the twin and the recurrence differ in summation order).

The tests marked ``cuda`` hold the KDA kernel to its twin at the published
widths and graphed beam search to the same segments run eagerly; this
file imports no JAX, so on the card: ``python -m pytest
tests/test_torch_kimi_linear.py --noconftest -m cuda -q``.
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
from clipcap_tpu_torch.models import kimi_linear as km
from clipcap_tpu_torch.models.decoding import beam_parent
from clipcap_tpu_torch.models.kimi_linear import (KIMI_PRESETS, init_kimi, init_kimi_cache,
                                                  kimi_apply, kimi_embed_tokens)
from clipcap_tpu_torch.ops import kda, moe

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from portbench.reference import kimi_linear as ref  # noqa: E402
from portbench.reference.numerics import Numerics  # noqa: E402

CFG = KIMI_PRESETS["kimi-linear-test"]
NEVER = -1      # a stop token no step emits


def _ref_cfg(cfg) -> dict:
    """The reference's dict of config keys for a port config."""
    c = dataclasses.asdict(cfg)
    c["experts_held"] = list(cfg.experts_held)
    return c


@pytest.fixture(scope="module")
def lm():
    return init_kimi(CFG, seed=5)


def _ref_logits(lm, embeds):
    W = lm.state_dict()
    num = Numerics("fp32")
    return ref.lm_logits(W, ref.kimi_hidden(W, embeds, _ref_cfg(lm.config), num), num)


def _close(got, want, tol=2e-5):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale, float((got - want).abs().max())


@pytest.mark.parametrize("held", [(0, 8), (3, 6)], ids=["all_experts", "a_share"])
def test_forward_matches_reference(held):
    lm = init_kimi(dataclasses.replace(CFG, experts_held=held), seed=5)
    x = torch.randn(3, 9, CFG.hidden_size, generator=torch.Generator().manual_seed(0))
    logits, _ = kimi_apply(lm, inputs_embeds=x)
    _close(logits, _ref_logits(lm, x))


# -- the KDA step ------------------------------------------------------------

H, D_HEAD = 2, 16


def _recurrence(xs, taps, gs, betas):
    """The KDA layer's arithmetic over one row's history from position 0:
    ``xs`` [T, 3, H·d] inputs before the convolutions, ``taps`` [3, H·d, 4],
    ``gs`` [T, H, d], ``betas`` [T, H] → the last position's o [H, d]."""
    T = xs.shape[0]
    pad = torch.cat([torch.zeros(3, 3, xs.shape[-1]), xs.permute(1, 0, 2)], dim=1)  # [3, T+3, ·]
    S = torch.zeros(H, D_HEAD, D_HEAD)
    for t in range(T):
        y = F.silu((pad[:, t:t + 4] * taps.transpose(1, 2)).sum(1))                 # [3, HD]
        q, k, v = (y[m].view(H, D_HEAD) for m in range(3))
        q = q / torch.sqrt(q.pow(2).sum(-1, keepdim=True) + kda.L2_EPS) * D_HEAD ** -0.5
        k = k / torch.sqrt(k.pow(2).sum(-1, keepdim=True) + kda.L2_EPS)
        S = S * gs[t].exp()[..., None]
        u = (v - torch.einsum("hij,hi->hj", S, k)) * betas[t][:, None]
        S = S + k[..., None] * u[:, None]
        o = torch.einsum("hij,hi->hj", S, q)
    return o


# Each step's parents of 6 rows (2 samples × 3 beams): random, repeated, all
# on one row, the identity.
PARENTS = [[-1] * 6, [2, 0, 1, 5, 5, 3], [1, 1, 1, 4, 4, 4], [0, 0, 0, 0, 0, 0],
           [0, 1, 2, 3, 4, 5], [2, 2, 0, 3, 5, 4]]


def test_kda_twin_matches_the_recurrence_over_each_rows_history():
    g = torch.Generator().manual_seed(11)
    B, HD = 6, H * D_HEAD
    taps = torch.randn(3, HD, 1, 4, generator=g) * 0.5
    windows = [torch.full((B, 3, 3, HD), float("nan")) for _ in range(2)]
    states = [torch.full((B, H, D_HEAD, D_HEAD), float("nan")) for _ in range(2)]
    history = [[] for _ in range(B)]
    for t, parents in enumerate(PARENTS):
        x = torch.randn(3, B, HD, generator=g)
        gl = -torch.rand(B, H, D_HEAD, generator=g) * 0.5
        beta = torch.rand(B, H, generator=g)
        parent = torch.tensor(parents, dtype=torch.int32)
        o = kda.kda_decode(x[0], x[1], x[2], *taps, gl, beta, parent, windows[t % 2],
                           windows[(t + 1) % 2], states[t % 2], states[(t + 1) % 2], 3)
        history = [(history[p] if p >= 0 else []) + [(x[:, b], gl[b], beta[b])]
                   for b, p in enumerate(parents)]
        for b in range(B):
            xs, gs, bs = (torch.stack(z) for z in zip(*history[b]))
            want = _recurrence(xs, taps[:, :, 0], gs, bs)
            torch.testing.assert_close(o[b], want, rtol=0, atol=1e-5)


def test_beam_parent_reads_the_ancestry_table():
    ancestry = torch.tensor([[0, 2, 1], [1, 0, 1], [2, 2, 0], [0, 0, 1], [1, 0, 0], [2, 1, 1]])
    assert beam_parent(ancestry, 3, 7, 7).tolist() == [0, 0, 0, 1, 1, 1]     # the prefill rows
    assert beam_parent(ancestry, 3, 8, 7).tolist() == [0, 1, 2, 3, 4, 5]
    assert beam_parent(ancestry, 3, 9, 7).tolist() == [2, 0, 2, 3, 3, 4]
    assert beam_parent(ancestry, 3, 9, 7).dtype == torch.int32


# -- prefill and beam decode through the hybrid cache ------------------------


def _beam_run(lm, g, reorders):
    """Prefill the folded prefix, then beam decode steps, the beams
    reordered by ``reorders[step]`` [R, K] after each step; yields each
    step's logits beside the reference's over each beam's own history."""
    R, K, P, N = 2, 3, 4, len(reorders) + 1
    B = R * K
    prefix = torch.randn(R, P, CFG.hidden_size, generator=g)
    cache = init_kimi_cache(CFG, B, N, dtype=torch.float32, beam_size=K, prefix_slots=P)
    kimi_apply(lm, inputs_embeds=prefix, kv_cache=cache, cache_index=0, return_logits=False)
    own = torch.arange(B) % K
    ancestry = own[:, None].repeat(1, N)
    history = [[] for _ in range(B)]
    for step in range(1, N):
        pos = P + step - 1
        ancestry[:, pos - P] = own
        tok = torch.randint(0, CFG.vocab_size, (B,), generator=g)
        for b in range(B):
            history[b].append(int(tok[b]))
        logits, _ = kimi_apply(lm, inputs_embeds=kimi_embed_tokens(lm, tok[:, None]),
                               kv_cache=cache, cache_index=pos, beam_size=K, ancestry=ancestry,
                               cache_base=P)
        for b in range(B):
            x = torch.cat([prefix[b // K], kimi_embed_tokens(lm, torch.tensor(history[b]))])
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
    """Each row continuing its own state, not its parent's, gives other
    logits once beams have swapped."""
    def own_rows(ancestry, beam_size, cache_index, cache_base):
        parent = beam_parent(ancestry, beam_size, cache_index, cache_base)
        if cache_index == cache_base:
            return parent
        return torch.arange(ancestry.shape[0], dtype=torch.int32)

    monkeypatch.setattr(km, "beam_parent", own_rows)
    gaps = [float((got - want).abs().max() / want.abs().max())
            for got, want in _beam_run(lm, torch.Generator().manual_seed(1), SWAPS)]
    assert max(gaps) > 1e-2, max(gaps)


# -- routing and the expert share ---------------------------------------------


def test_sigmoid_routing_matches_the_formula():
    """Top-k by sigmoid score + selection bias, weighed by the unbiased
    scores renormalised × the scaling factor; a bias that moves an expert
    into the chosen set."""
    cfg = dataclasses.replace(CFG, num_experts=8, num_experts_per_token=2, experts_held=(0, 8))
    layer = dsv2._MoE(cfg)
    W = torch.tensor([[1.0, 0.0], [0.9, 0.0], [0.0, 1.0], [0.1, 0.1],
                      [-1.0, 0.0], [0.0, -1.0], [0.5, 0.5], [0.2, 0.0]])
    layer.gate.weight = torch.nn.Parameter(F.pad(W, (0, cfg.hidden_size - 2)),
                                           requires_grad=False)
    h = F.pad(torch.tensor([[2.0, 0.0]]), (0, cfg.hidden_size - 2))
    for bias, chosen in (([0.0] * 8, {0, 1}), ([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], {0, 7})):
        layer.gate.e_score_correction_bias = torch.nn.Parameter(torch.tensor(bias),
                                                                requires_grad=False)
        w, idx = dsv2._route(layer, h, cfg)
        assert set(idx[0].tolist()) == chosen
        s = torch.sigmoid(h @ layer.gate.weight.t())[0, idx[0]]
        torch.testing.assert_close(w[0], s / s.sum() * cfg.routed_scaling_factor)


def test_expert_shares_add_up_to_the_uncut_layer():
    """Eight chips' shares of 16 experts, 2 each: their partial outputs, the
    shared expert counted once, add up to the reference's whole layer."""
    whole = dataclasses.replace(CFG, num_experts=16, experts_held=(0, 16))
    lm = init_kimi(whole, seed=3)
    W = lm.state_dict()
    p = "model.layers.1.mlp."
    h = torch.randn(1, 7, CFG.hidden_size, generator=torch.Generator().manual_seed(4))
    rc = _ref_cfg(whole)
    want = ref._moe(W, p, h, rc, Numerics("fp32"))
    shared = ref._mlp(W, p + "shared_experts.", h.reshape(-1, CFG.hidden_size),
                      Numerics("fp32")).view_as(h)
    total = shared.clone()
    for chip in range(8):
        held = (2 * chip, 2 * chip + 2)
        cfg = dataclasses.replace(whole, experts_held=held)
        layer = dsv2._MoE(cfg)
        sd = {k[len(p):]: v for k, v in W.items() if k.startswith(p)}
        for n in ("gate_up_proj", "down_proj"):
            sd[f"experts.{n}"] = sd[f"experts.{n}"][held[0]:held[1]]
        layer.load_state_dict(sd, assign=True)
        total += dsv2._moe(layer, h, cfg) - shared
    _close(total, want)


def test_grouped_experts_leave_rows_past_the_last_offset_unread():
    g = torch.Generator().manual_seed(2)
    E, D, Fw, M = 3, 32, 16, 12
    offsets = torch.tensor([0, 2, 2, 7], dtype=torch.int32)
    x = torch.randn(M, D, generator=g)
    x[7:] = float("nan")
    w13 = torch.randn(E, 2 * Fw, D, generator=g) * 0.1
    w2 = torch.randn(E, D, Fw, generator=g) * 0.1
    got = moe.grouped_expert_mlp(x, w13, w2, offsets)
    want = moe.grouped_expert_mlp_ref(x[:7], w13, w2, offsets)
    torch.testing.assert_close(got[:7], want)
    assert bool(torch.isfinite(got).all())


# -- the beam loop and the refusals -------------------------------------------


def test_beam_scores_match_reference_log_probability(lm):
    R, K, P, N = 2, 3, 4, 5
    prefix = torch.randn(R, P, CFG.hidden_size, generator=torch.Generator().manual_seed(6))
    res = beam_search_batched(lm, prefix, BeamParams(beam_size=K, max_new_tokens=N,
                                                     stop_token=NEVER), dtype=torch.float32)
    W = lm.state_dict()
    for r in range(R):
        for k in range(K):
            t = res.tokens[r, k]
            x = torch.cat([prefix[r], ref.token_embeds(W, t[:-1])])[None]
            h = ref.kimi_hidden(W, x, _ref_cfg(CFG), Numerics("fp32"))[0, P - 1:]
            logp = torch.log_softmax(ref.lm_logits(W, h, Numerics("fp32")), -1)
            want = logp.gather(-1, t[:, None]).mean()
            assert abs(float(res.scores[r, k]) - float(want)) < 1e-5


def test_beam_search_counts_kimi_steps(lm):
    before = (beam_search_batched.decode_steps, beam_search_batched.host_syncs,
              kda.kda_decode.calls)
    prefix = torch.randn(1, 3, CFG.hidden_size)
    beam_search_batched(lm, prefix, BeamParams(beam_size=2, max_new_tokens=4, stop_token=NEVER),
                        dtype=torch.float32)
    assert beam_search_batched.decode_steps == before[0] + 3
    assert beam_search_batched.host_syncs == before[1] + 3
    # 3 KDA layers: the prefill's 3 positions, then 3 steps.
    assert kda.kda_decode.calls == before[2] + 3 * (3 + 3)


@pytest.mark.parametrize("params", [dict(int8_kv=True), dict(consolidate_every=2),
                                    dict(tile_major=True), dict(fold_prefix=False)],
                         ids=["int8_kv", "consolidated", "tile_major", "replicated_prefix"])
def test_cache_forms_the_hybrid_cache_lacks_raise(lm, params):
    prefix = torch.randn(1, 3, CFG.hidden_size)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, F13"):
        beam_search_batched(lm, prefix, BeamParams(beam_size=2, max_new_tokens=3, **params),
                            dtype=torch.float32)


def test_configs_the_port_lacks_raise():
    hf = dict(dataclasses.asdict(CFG), mla_use_nope=True)
    hf["linear_attn_config"] = dataclasses.asdict(CFG.linear_attn_config)
    assert km.kimi_config_from_hf(hf).experts_held == (0, CFG.num_experts)
    with pytest.raises(NotImplementedError, match="query LoRA"):
        km.kimi_config_from_hf(dict(hf, q_lora_rank=16))
    with pytest.raises(NotImplementedError, match="rotary MLA"):
        km.kimi_config_from_hf(dict(hf, mla_use_nope=False))


def _clipcap(seed=0):
    from clipcap_tpu_torch.config import Config, EncoderConfig
    from clipcap_tpu_torch.models.clipcap import init_clipcap

    config = Config(language_model="kimi-linear-test", prefix_length=4, projection_length=4,
                    transformer_layers=2, transformer_attention_heads=4,
                    encoder_config=EncoderConfig(encoder_model_variant="test-tiny",
                                                 encoder_embedding_size=32))
    return config, init_clipcap(config, seed=seed)


def test_clipcap_captions_with_kimi_and_refuses_training_and_sampling():
    from clipcap_tpu_torch.inference.engine import SamplingParams, decode
    from clipcap_tpu_torch.models.clipcap import clipcap_loss
    from clipcap_tpu_torch.models.mapper import mapper_apply

    _, model = _clipcap()
    assert isinstance(model.language_model, km.KimiLinear)
    assert model.transformer_mapper.config.lm_embedding_size == CFG.hidden_size
    emb = torch.randn(2, 32, generator=torch.Generator().manual_seed(7))
    prefix = mapper_apply(model.transformer_mapper, emb, dtype=torch.float32)
    res = beam_search_batched(model.language_model, prefix,
                              BeamParams(beam_size=2, max_new_tokens=3, stop_token=NEVER),
                              dtype=torch.float32)
    assert res.tokens.shape == (2, 2, 3) and bool(torch.isfinite(res.scores).all())
    with pytest.raises(NotImplementedError, match="ROADMAP.md, F13"):
        clipcap_loss(model, torch.zeros(2, 3, dtype=torch.long), emb)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, F13"):
        decode(model.language_model, prefix, torch.Generator(), SamplingParams())


def test_decode_graph_keys_follow_the_kimi_weights(lm):
    """A key's graphs hold a segment per cut plus one: per layer its KDA
    step or latent attention, and its experts."""
    key = (6, 3, torch.bfloat16, torch.device("cuda", 0))    # a key only: nothing runs
    graphs = lm.decode_graphs.get(lm, key)
    assert graphs.segments == 1 + CFG.num_hidden_layers + 3 == len(lm.cuts) + 1
    assert [k for k, _ in lm.cuts] == ["kda", "kda", "moe", "attn", "moe", "kda", "moe"]
    lm.model.layers[3].self_attn.A_log.data = lm.model.layers[3].self_attn.A_log.data.clone()
    assert lm.decode_graphs.get(lm, key) is not graphs


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# Kernel-sized widths: KDA heads of 128, D a multiple of 128, F of 64.
CARD_CFG = dataclasses.replace(
    CFG, hidden_size=256, intermediate_size=512, moe_intermediate_size=128,
    num_attention_heads=2, kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
    v_head_dim=32, num_experts=16, num_experts_per_token=4, experts_held=(4, 12),
    vocab_size=1000, linear_attn_config=dataclasses.replace(CFG.linear_attn_config,
                                                            head_dim=128, num_heads=2),
    name="card")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the KDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_kda_kernel_matches_twin_at_published_widths(cuda, dtype):
    """480 rows (96 samples × 5 beams), 32 heads of 128, two steps: parents
    random, repeated and all five beams on one parent."""
    g = torch.Generator().manual_seed(12)
    R, K, Hh, d = 96, 5, 32, 128
    B, HD = R * K, Hh * d
    taps = (torch.randn(3, HD, 1, 4, generator=g) * 0.5).to(cuda, dtype)
    rows = torch.arange(B) // K * K
    parents = [torch.full((B,), -1), rows + torch.randint(0, K, (B,), generator=g)]
    parents[1][:K] = 2                                       # one parent for all five
    win = [torch.randn(B, 3, 3, HD, generator=g).to(cuda, dtype) for _ in range(2)]
    st = [torch.randn(B, Hh, d, d, generator=g).to(cuda) * 0.1 for _ in range(2)]
    twin_win = [w.clone() for w in win]
    twin_st = [s.clone() for s in st]
    launches = kda.kda_decode.launches
    for t, parent in enumerate(parents):
        x = (torch.randn(3, B, HD, generator=g) * 2).to(cuda, dtype)
        gl = (-torch.rand(B, Hh, d, generator=g)).to(cuda)
        beta = torch.rand(B, Hh, generator=g).to(cuda)
        p = parent.to(cuda, torch.int32)
        got = kda.kda_decode(x[0], x[1], x[2], *taps, gl, beta, p, win[t % 2],
                             win[(t + 1) % 2], st[t % 2], st[(t + 1) % 2], K)
        want = kda.kda_decode_ref(x[0], x[1], x[2], *taps, gl, beta, p, twin_win[t % 2],
                                  twin_win[(t + 1) % 2], twin_st[t % 2], twin_st[(t + 1) % 2],
                                  K)
        torch.cuda.synchronize()
        # fp32 sums over 128 in another order; the output rounded to dtype.
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        scale = float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= tol * scale
        torch.testing.assert_close(st[(t + 1) % 2], twin_st[(t + 1) % 2], rtol=1e-4, atol=1e-5)
        assert torch.equal(win[(t + 1) % 2], twin_win[(t + 1) % 2])
    assert kda.kda_decode.launches == launches + 2


@pytest.mark.cuda
def test_graphed_kimi_beam_search_equals_eager(cuda, monkeypatch):
    """Graphed decode steps give the tokens, lengths and scores of the same
    segments run eagerly, bit for bit (a share of the experts held)."""
    lm = init_kimi(CARD_CFG, seed=9).to(cuda, torch.bfloat16)
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
