"""``ops/quick_gelu.py``: CLIP's QuickGELU as one CUDA pass, forward and backward.

On the CPU: the plain twins against the JAX package's ``quick_gelu`` (values,
and gradients by ``jax.vjp``) in fp32 and bf16; every name the models and
the benchmark resolve is the new wrapper; a CPU tensor takes the plain path
and launches nothing; the benchmark's ``quick_gelu_roofline`` reads its
entry's bytes at the embed cell's shape.  The tests marked ``cuda`` hold
the kernels to the float32 formula on the card (sizes 1, 7, 8k + 3, the
embed cell's shape, a view off 16 bytes), count one launch a call each way,
order the launch on its tensors' stream and device, replay it inside a
GPT-2's decode graphs and count one a block in a ViT tower.  They import no
JAX: run them with
``python -m pytest tests/test_torch_quick_gelu.py --noconftest -m cuda -q``.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clipcap_tpu_torch.convert import gpt2_from_params
from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
from clipcap_tpu_torch.models import clip_vit
from clipcap_tpu_torch.models.gpt2 import GPT2Config, init_gpt2
from clipcap_tpu_torch.ops import layers
from clipcap_tpu_torch.ops.quick_gelu import (QuickGELUFunction, quick_gelu,
                                              quick_gelu_backward_plain, quick_gelu_plain)
from portbench import harness

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
EMBED_SHAPE = (256, 257, 4096)        # ViT-L/14 b256's c_fc output
NEVER = -1    # a stop token no step emits: the search runs to max_new_tokens


def _inputs(shape, dtype, seed: int = 26, device="cpu"):
    """Values at the activation's scale (randn × 3) and, in the first
    elements, a sweep of [-20, 20] where the sigmoid saturates."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device) * 3
    flat = x.view(-1)
    k = min(flat.numel(), 4001)
    flat[:k] = torch.linspace(-20, 20, k, device=device)
    return x.to(dtype)


def _jax(x):
    """A torch tensor as a JAX array of the same dtype, value for value."""
    import jax.numpy as jnp

    a = jnp.asarray(x.float().numpy())
    return a.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else a


def _np(a):
    return np.asarray(a, dtype=np.float32)


# bf16: JAX rounds the constant 1.702 to bf16 (1.703125) and each op to
# bf16; torch keeps 1.702 in float32.  The two chains then differ by a few
# bf16 ulps (2^-8 relative), far under what a wrong formula misses by.
TOL = {"fp32": dict(rtol=1e-6, atol=1e-6), "bf16": dict(rtol=3 * 2 ** -8, atol=2 ** -8)}


@pytest.mark.parametrize("shape", [(7,), (3, 5, 13)], ids=["7", "3x5x13"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_twin_matches_jax(dtype, shape):
    """The twin against the JAX package's ``quick_gelu``: values, and the
    input gradient by autograd through the twin against ``jax.vjp``."""
    import jax

    from clipcap_tpu.ops import layers as jlayers     # the cuda tests here import no JAX

    x = _inputs(shape, DTYPES[dtype])
    up = _inputs(shape, DTYPES[dtype], seed=27) / 3
    want, vjp = jax.vjp(jlayers.ACTIVATIONS["quick_gelu"], _jax(x))
    (want_grad,) = vjp(_jax(up))
    leaf = x.clone().requires_grad_()
    got = quick_gelu_plain(leaf)
    got.backward(up)
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want), **TOL[dtype])
    np.testing.assert_allclose(leaf.grad.float().numpy(), _np(want_grad), **TOL[dtype])


@pytest.mark.parametrize("shape", [(7,), (3, 5, 13)], ids=["7", "3x5x13"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_function_backward_matches_jax_vjp(dtype, shape):
    """The backward kernel's formula, as its plain twin, against ``jax.vjp``
    through the JAX package's function."""
    import jax

    from clipcap_tpu.ops import layers as jlayers

    x = _inputs(shape, DTYPES[dtype])
    up = _inputs(shape, DTYPES[dtype], seed=28) / 3
    _, vjp = jax.vjp(jlayers.ACTIVATIONS["quick_gelu"], _jax(x))
    (want,) = vjp(_jax(up))
    got = quick_gelu_backward_plain(x, up)
    assert got.dtype == x.dtype
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])


def test_every_name_is_the_wrapper():
    """``ACTIVATIONS["quick_gelu"]``, ``layers.quick_gelu`` and the name the
    ViT block calls (which the benchmark's entry resolves) are the one
    wrapper."""
    assert layers.ACTIVATIONS["quick_gelu"] is quick_gelu
    assert layers.quick_gelu is quick_gelu
    assert clip_vit.quick_gelu is quick_gelu
    mod = harness.metric_module("quick_gelu_roofline")
    module, attr = mod.ENTRY.split(":")
    assert (module, attr) == ("clipcap_tpu_torch.models.clip_vit", "quick_gelu")


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_cpu_takes_the_plain_path(grad):
    """A CPU tensor: the twin's values bit for bit, with or without
    autograd, a call counted and no launch; a ViT tower on the CPU calls it
    once a block."""
    x = _inputs((4, 9, 33), torch.bfloat16).requires_grad_(grad)
    calls, launches = quick_gelu.calls, quick_gelu.launches
    y = quick_gelu(x)
    assert torch.equal(y, quick_gelu_plain(x))
    if grad:
        y.sum().backward()
        assert x.grad is not None
    assert (quick_gelu.calls, quick_gelu.launches) == (calls + 1, launches)
    model, cfg = clip_vit.load_clip("test-tiny")
    images = torch.zeros(2, cfg.vision.image_size, cfg.vision.image_size, 3, dtype=torch.uint8)
    with torch.no_grad():
        clip_vit.clip_encode_image(model.visual, images)
    assert quick_gelu.calls == calls + 1 + cfg.vision.layers
    assert quick_gelu.launches == launches


def test_roofline_facts_at_the_embed_shape():
    """``quick_gelu_roofline``'s facts of one full block call of the embed
    cell: x read and the output written once, 1,077,936,128 bytes, 0.3218 ms
    at 3.35 TB/s; the metric's entry in ``BENCHMARK.json`` lists that cell."""
    from portbench.peaks import bound_s

    mod = harness.metric_module("quick_gelu_roofline")
    x = torch.empty(EMBED_SHAPE, dtype=torch.bfloat16, device="meta")
    nbytes, ops, dtype = mod.facts(x)
    assert (nbytes, ops, dtype) == (1_077_936_128, 5 * x.numel(), "bfloat16")
    assert round(bound_s(nbytes, ops, dtype) * 1e3, 4) == 0.3218
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = next(m for m in bench["per_layer"] if m["name"] == "quick_gelu_roofline")
    assert (entry["layer"], entry["moves"]) == (mod.LAYER, mod.MOVES) == ("MLP activation",
                                                                        "embeds_per_s")
    assert (entry["unit"], entry["better"], entry["source"]) == ("%", "higher", "device_trace")
    assert entry["workloads"] == ["embed.vitl14.b256"]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# Head size 64, as the decode and encoder attention kernels take it.
CARD_LM = GPT2Config(vocab_size=1000, n_positions=128, n_embd=128, n_layer=3, n_head=2,
                     activation="quick_gelu", name="card")
CARD_VIT = clip_vit.CLIPVisionConfig(image_size=56, patch_size=14, width=128, layers=3, heads=2,
                                     embed_dim=32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the QuickGELU kernels")
    return torch.device("cuda")


def _formula(x):
    """The float32 formula (the eager chain in float32) of ``x``."""
    return quick_gelu_plain(x.float())


def _assert_close(got, want, scale=None):
    """bf16: each element within one bf16 ulp of the float32 ``want``
    (floored at 2^-20 near zero); fp32: within 1e-6 of ``|want|`` (+
    ``scale``, the size of the terms that cancel where ``want`` is near 0)."""
    want = want.float()
    if got.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -13))) - 7)
        miss = int(((got.float() - want).abs() > ulp).sum())
    else:
        room = 1e-6 * (want.abs() + (0 if scale is None else scale.abs()))
        miss = int(((got - want).abs() > room).sum())
    assert miss == 0, f"{miss} of {got.numel()} elements off"


def _card_case(case: str, dtype, dev) -> torch.Tensor:
    if case == "storage_offset_1":
        base = _inputs(8 * 1000 + 4, dtype, device=dev)
        x = base[1:]
        assert x.storage_offset() == 1 and x.is_contiguous()
        return x
    n = {"n1": (1,), "n7": (7,), "n8k_3": (8 * 4099 + 3,), "embed": EMBED_SHAPE}[case]
    return _inputs(n, dtype, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n1", "n7", "n8k_3", "embed", "storage_offset_1"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_matches_the_formula(cuda, dtype, case):
    """Forward against the float32 formula, backward against the plain
    backward in float32: within one bf16 ulp (bf16), 1e-6 relative (fp32)."""
    x = _card_case(case, DTYPES[dtype], cuda)
    _assert_close(quick_gelu(x), _formula(x))
    dy = _inputs(x.shape, DTYPES[dtype], seed=29, device=cuda) / 3
    leaf = x.detach().clone().requires_grad_()
    quick_gelu(leaf).backward(dy)
    _assert_close(leaf.grad, quick_gelu_backward_plain(x.float(), dy.float()), scale=dy.float())


def _kernels(fn) -> int:
    """Device kernels launched by one call of ``fn``, by ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


@pytest.mark.cuda
def test_one_launch_a_call_each_way(cuda):
    """One kernel forward and one backward at ViT-L/14 b256's shape, each
    counted in ``quick_gelu.launches``; under autograd ``x`` is the one
    tensor saved."""
    x = _inputs(EMBED_SHAPE, torch.bfloat16, device=cuda)
    n0 = quick_gelu.launches
    assert _kernels(lambda: quick_gelu(x)) == 1
    assert quick_gelu.launches == n0 + 2
    leaf = x.clone().requires_grad_()
    y = quick_gelu(leaf)
    assert isinstance(y.grad_fn, QuickGELUFunction._backward_cls)
    assert len(y.grad_fn.saved_tensors) == 1 and y.grad_fn.saved_tensors[0] is leaf
    up = torch.ones_like(y)
    n0 = quick_gelu.launches
    assert _kernels(lambda: torch.autograd.grad(y, leaf, up, retain_graph=True)) == 1
    assert quick_gelu.launches == n0 + 2


@pytest.mark.cuda
def test_launches_on_its_tensors_stream_and_device(cuda):
    """The kernel runs on the current stream of its tensor's device (the
    last visible card), ordered after the work queued there before it: x is
    written on a side stream behind a ~30 ms spin, and the output still
    sees it."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    want_x = _inputs((300_001,), torch.bfloat16, device=dev)
    x = torch.zeros_like(want_x)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    n0 = quick_gelu.launches
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        x.copy_(want_x)
        y = quick_gelu(x)
    side.synchronize()
    assert y.device == dev and quick_gelu.launches == n0 + 1
    _assert_close(y, _formula(want_x))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp16", "non_contiguous"])
def test_refuses_what_the_kernel_does_not_take(cuda, case):
    x = _inputs((64, 96), torch.float32, device=cuda)
    x = x.half() if case == "fp16" else x.t()
    with pytest.raises(ValueError):
        quick_gelu(x)


@pytest.mark.cuda
def test_graphed_decode_replays_the_kernel(cuda, monkeypatch):
    """A GPT-2 whose config says ``quick_gelu``: the kernel is captured in
    the decode graphs' dense segments, and the graphed beam search's
    tokens, lengths and scores are bit-identical to its eager segments'."""
    lm = gpt2_from_params(init_gpt2(CARD_LM, seed=5), CARD_LM).to(cuda, torch.bfloat16)
    bp = BeamParams(beam_size=5, max_new_tokens=12, stop_token=NEVER)
    prefix = torch.randn(3, 4, CARD_LM.n_embd,
                         generator=torch.Generator(device=cuda).manual_seed(7), device=cuda)
    monkeypatch.setattr(beam_mod, "decode_step_graphs", lambda *a, **k: None)
    n0 = quick_gelu.launches
    want = beam_search_batched(lm, prefix, bp, dtype=torch.bfloat16)
    assert quick_gelu.launches - n0 == CARD_LM.n_layer * bp.max_new_tokens
    monkeypatch.undo()
    graphed = beam_search_batched.graph_steps
    got = beam_search_batched(lm, prefix, bp, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert beam_search_batched.graph_steps > graphed
    for name in ("tokens", "seq_lengths", "scores"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.cuda
def test_tower_launches_once_a_block(cuda):
    """A bf16 ViT tower on the card: one kernel a block (the last block's
    one class-token row too), no eager sigmoid."""
    visual = clip_vit.VisionTransformer(CARD_VIT)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in visual.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    visual = visual.to(cuda, torch.bfloat16)
    images = torch.rand(2, 56, 56, 3, generator=torch.Generator(device=cuda).manual_seed(4),
                        device=cuda)
    n0 = quick_gelu.launches
    with torch.no_grad():
        clip_vit.clip_encode_image(visual, images, dtype=torch.bfloat16)
    assert quick_gelu.launches - n0 == CARD_VIT.layers
    with profile(activities=[ProfilerActivity.CUDA]) as prof, torch.no_grad():
        clip_vit.clip_encode_image(visual, images, dtype=torch.bfloat16)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("quick_gelu" in n for n in names) == CARD_VIT.layers
    assert not any("sigmoid" in n for n in names)

