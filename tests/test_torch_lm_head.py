"""The GPT-2 LM head on a vocabulary padded to a multiple of 64 rows.

``models/gpt2.py::lm_logits`` multiplies by a head padded with zero rows to
a multiple of ``HEAD_ROW_QUANTUM``, made in each call, and returns the
``[..., :V]`` view of the product.  Every case is held to the unpadded
product ``hidden @ wte.weight.to(dtype).t()``, computed here, on tiny
models with an odd vocabulary and with one that is a multiple of 64 (no
pad rows).

The tests marked ``cuda`` hold beam search and the CE loss on the card to
the same search and loss through the unpadded product.  The file imports
no JAX: run them with ``python -m pytest tests/test_torch_lm_head.py
--noconftest -m cuda -q``.
"""
import pytest
import torch

from clipcap_tpu_torch.config import Config, EncoderConfig
from clipcap_tpu_torch.convert import gpt2_from_params
from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
from clipcap_tpu_torch.models import clipcap as clipcap_mod
from clipcap_tpu_torch.models import gpt2
from clipcap_tpu_torch.models.clipcap import clipcap_loss, init_clipcap
from clipcap_tpu_torch.models.gpt2 import GPT2Config, init_gpt2, lm_logits

TOL = dict(atol=1e-5, rtol=1e-5)      # fp32: the same products, another blocking
BF16_TOL = 2e-2                       # the port's bf16 tolerance (test_torch_kv.py)
LOSS_REL = 1.8e-4                     # the train cell's limits (portbench/workloads)
GRAD_GAP = 0.08
VOCABS = {"odd": 1001, "aligned": 1024}


def _cfg(vocab: int) -> GPT2Config:
    return GPT2Config(vocab_size=vocab, n_positions=64, n_embd=32, n_layer=2, n_head=2,
                      name=f"head{vocab}")


def _lm(vocab: int, seed: int = 0) -> gpt2.GPT2:
    cfg = _cfg(vocab)
    return gpt2_from_params(init_gpt2(cfg, seed=seed), cfg)


def unpadded(model, hidden):
    """The head's product before the padding."""
    return hidden @ model.wte.weight.to(hidden.dtype).t()


@pytest.fixture(params=sorted(VOCABS))
def vocab(request):
    return VOCABS[request.param]


def _hidden(shape, seed=1, requires_grad=False, device="cpu", dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn(*shape, generator=g, device=device, dtype=dtype)
    return h.requires_grad_(requires_grad)


# ---------------------------------------------------------------------------
# Logits and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 32), (3, 5, 32), "strided"])
def test_logits_equal_the_unpadded_product(vocab, shape):
    """Rows, a batch of rows, and a loss chunk's strided slice of one."""
    lm = _lm(vocab)
    h = _hidden(shape) if shape != "strided" else _hidden((3, 9, 32))[:, 2:7]
    with torch.no_grad():
        got = lm_logits(lm, h)
    assert got.shape == (*h.shape[:-1], vocab)
    torch.testing.assert_close(got, unpadded(lm, h), **TOL)


def test_frozen_head_gradient_to_the_hidden_states(vocab):
    lm = _lm(vocab)
    assert not lm.wte.weight.requires_grad
    target = _hidden((6, vocab), seed=2)
    grads = []
    for head in (lm_logits, unpadded):
        h = _hidden((6, 32), requires_grad=True)
        (torch.log_softmax(head(lm, h), -1) * target).sum().backward()
        grads.append(h.grad)
    torch.testing.assert_close(grads[0], grads[1], **TOL)


def test_trainable_head_gradients_reach_wte(vocab):
    """Full finetune: the tied head learns through the product too; the
    padded product gives ``wte`` and the hidden states the unpadded
    gradients."""
    target = _hidden((2, 3, vocab), seed=2)
    got = []
    for head in (lm_logits, unpadded):
        lm = _lm(vocab)
        lm.wte.weight.requires_grad_(True)
        h = _hidden((2, 3, 32), requires_grad=True)
        (torch.log_softmax(head(lm, h), -1) * target).sum().backward()
        got.append((lm.wte.weight.grad, h.grad))
    for a, b in zip(*got):
        torch.testing.assert_close(a, b, **TOL)


def test_logits_in_the_dtype_of_the_hidden_states(vocab):
    lm = _lm(vocab)
    h = _hidden((4, 32)).bfloat16()
    with torch.no_grad():
        got = lm_logits(lm, h)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), unpadded(lm, h).float(), atol=BF16_TOL, rtol=0)


# ---------------------------------------------------------------------------
# The head follows wte; the model keeps no padded state
# ---------------------------------------------------------------------------


def _write_in_place(lm):
    with torch.no_grad():
        lm.wte.weight.mul_(2.0)


def _assign(lm):
    sd = {k: v.clone() for k, v in lm.state_dict().items()}
    sd["wte.weight"] = sd["wte.weight"] * -1.0
    lm.load_state_dict(sd, assign=True)


def _copy_into(lm):
    sd = {k: v.clone() for k, v in lm.state_dict().items()}
    sd["wte.weight"] = sd["wte.weight"] + 1.0
    lm.load_state_dict(sd)


def _cast_round_trip(lm):
    lm.to(torch.bfloat16)
    lm.float()


CHANGES = {"in_place": _write_in_place, "assign": _assign, "load_copy": _copy_into,
           "cast": _cast_round_trip}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_logits_follow_wte_after_it_changes(change):
    """Written in place, replaced, loaded into, cast and cast back: the next
    call reads the weight as it is then."""
    lm = _lm(VOCABS["odd"])
    h = _hidden((4, 32))
    with torch.no_grad():
        first = lm_logits(lm, h)
        CHANGES[change](lm)
        got = lm_logits(lm, h)
    torch.testing.assert_close(got, unpadded(lm, h), **TOL)
    if change != "cast":
        assert not torch.allclose(got, first)


def test_head_leaves_the_model_state_as_it_was():
    """The padded head is not kept: no new entry in the state dict, the
    params tree or a copy, and ``wte`` keeps its V rows."""
    config = Config(language_model="head1001", prefix_length=4, projection_length=4,
                    transformer_layers=1, transformer_attention_heads=2,
                    encoder_config=EncoderConfig(encoder_embedding_size=16))
    model = init_clipcap(config, lm_config=_cfg(VOCABS["odd"]), seed=0)
    lm = model.language_model
    sd_before = set(model.state_dict())
    params_before = model.params()
    attrs_before = set(vars(lm))
    with torch.no_grad():
        lm_logits(lm, _hidden((2, 32)))
    assert set(model.state_dict()) == sd_before
    assert set(vars(lm)) == attrs_before
    assert all(t.shape[0] == VOCABS["odd"] for k, t in model.state_dict().items()
               if k.endswith("wte.weight"))
    params = model.params()
    assert params["lm"].keys() == params_before["lm"].keys()
    assert params["lm"]["wte"].shape == params_before["lm"]["wte"].shape


# ---------------------------------------------------------------------------
# On the card: beam search and the CE loss against the unpadded product
# ---------------------------------------------------------------------------

CARD_LM = GPT2Config(vocab_size=50257, n_positions=128, n_embd=128, n_layer=2, n_head=2,
                     name="card-head")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the head's cuBLAS kernels and the decode kernels "
                    "have no CPU mode")
    return torch.device("cuda")


def _unpadded_search(lm, prefix, bp, dtype, monkeypatch):
    monkeypatch.setattr(gpt2, "lm_logits", unpadded)
    monkeypatch.setattr(beam_mod, "lm_logits", unpadded)
    try:
        res = beam_search_batched(lm, prefix, bp, dtype=dtype)
        torch.cuda.synchronize()
    finally:
        monkeypatch.undo()
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beam_search_matches_the_unpadded_head(cuda, dtype, monkeypatch):
    lm = gpt2_from_params(init_gpt2(CARD_LM, seed=11), CARD_LM).to(cuda, dtype)
    prefix = _hidden((4, 5, CARD_LM.n_embd), seed=12, device=cuda)
    bp = BeamParams(beam_size=5, max_new_tokens=16, stop_token=-1)
    got = beam_search_batched(lm, prefix, bp, dtype=dtype)
    torch.cuda.synchronize()
    want = _unpadded_search(lm, prefix, bp, dtype, monkeypatch)
    if dtype == torch.float32:
        assert torch.equal(got.tokens, want.tokens)
        torch.testing.assert_close(got.scores, want.scores, **TOL)
    else:
        torch.testing.assert_close(got.scores, want.scores, atol=BF16_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("train_lm", [False, True], ids=["frozen", "trainable"])
def test_loss_and_mapper_gradient_match_the_unpadded_head(cuda, train_lm, monkeypatch):
    """The train cell's step in miniature: fp32 weights, bf16 compute,
    checkpointed CE chunks; the loss within ``loss_rel`` and each mapper
    leaf's gradient within ``grad_gap`` of the unpadded head's."""
    config = Config(language_model="card-head", prefix_length=4, projection_length=4,
                    transformer_layers=1, transformer_attention_heads=2,
                    encoder_config=EncoderConfig(encoder_embedding_size=64))
    model = init_clipcap(config, lm_config=CARD_LM, seed=13).to(cuda)
    model.transformer_mapper.requires_grad_(True)
    model.language_model.requires_grad_(train_lm)
    g = torch.Generator(device=cuda).manual_seed(14)
    tokens = torch.randint(0, CARD_LM.vocab_size, (8, 40), generator=g, device=cuda)
    tokens[:, 30:] = -1
    emb = torch.randn(8, 64, generator=g, device=cuda)

    def run():
        model.zero_grad(set_to_none=True)
        loss = clipcap_loss(model, tokens, emb, dtype=torch.bfloat16, remat=True)
        loss.backward()
        return float(loss.detach()), {n: p.grad.float().clone()
                             for n, p in model.transformer_mapper.named_parameters()}

    loss, grads = run()
    monkeypatch.setattr(clipcap_mod, "lm_logits", unpadded)
    want_loss, want = run()
    monkeypatch.undo()
    assert abs(loss - want_loss) <= LOSS_REL * abs(want_loss)
    scale = torch.stack([w.norm() for w in want.values()]).median()
    for n, w in want.items():
        assert (grads[n] - w).norm() <= GRAD_GAP * torch.maximum(w.norm(), scale), n
