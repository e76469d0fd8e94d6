"""``ops/layers.py::linear`` with a bias: the bias goes into the GEMM.

A biased ``linear`` over a dense weight is one ``addmm`` (on the card one
cuBLASLt GEMM whose epilogue adds the bias to the fp32 accumulator) where
it was a product and a broadcast add.  The CPU tests hold it to that old
form (``x @ w + b``, rounded twice) within each dtype's rounding, hold the
unbiased and int8 paths to their old form bit for bit, compare gradients
under autograd and count the calls.  The tests marked ``cuda`` count the
kernels of one call at the block shapes of the cells (ViT-L/14 b256, GPT-2
XL and GPT-2 b128 decode steps, the mapper at width 1,600) and hold a
CUDA graph over a GPT-2 XL-width decode segment to the eager segment bit
for bit.  The file imports no JAX: on the card run it with
``python -m pytest tests/test_torch_linear_bias.py --noconftest -m cuda -q``.
"""
import math
import zlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clipcap_tpu_torch.ops import layers
from clipcap_tpu_torch.ops.layers import Conv1D, Int8Weight, Linear, linear

DTYPES = {"fp32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
          "bf16_x_fp32_w": (torch.bfloat16, torch.float32)}


def _old(x, w, b):
    """The form before: the product, then a broadcast add of the bias."""
    y = x @ w.to(x.dtype)
    return y + b.to(y.dtype)


def _x(shape: str, n_in: int, dtype, g) -> torch.Tensor:
    """The input of a case: 2-D, 3-D, a non-contiguous [B, 1, D] slice (the
    class-token row of ``_clip_block_cls``) or one row."""
    if shape == "2d":
        return torch.randn(7, n_in, generator=g).to(dtype)
    if shape == "3d":
        return torch.randn(3, 5, n_in, generator=g).to(dtype)
    if shape == "noncontig":
        return torch.randn(4, 6, n_in, generator=g).to(dtype)[:, :1]
    return torch.randn(1, n_in, generator=g).to(dtype)


def _w(layout: str, n_in: int, n_out: int, dtype, g) -> torch.Tensor:
    """A weight as ``linear`` takes it: ``[in, out]`` (``Conv1D``) or the
    ``.t()`` view of an ``[out, in]`` one (``Linear``)."""
    if layout == "conv1d":
        return (torch.randn(n_in, n_out, generator=g) * n_in ** -0.5).to(dtype)
    return (torch.randn(n_out, n_in, generator=g) * n_in ** -0.5).to(dtype).t()


def _bf16_ulp(ref: torch.Tensor) -> float:
    """One bf16 ulp at the output's scale (its largest magnitude)."""
    return 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)


@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("layout", ["conv1d", "linear_t"])
@pytest.mark.parametrize("shape", ["2d", "3d", "noncontig", "one_row"])
def test_biased_linear_matches_product_plus_bias(shape, layout, dtypes):
    """Within fp32's rounding (1e-5 relative) of the old form, or within one
    bf16 ulp of the output's scale of both the old form and the fp32 sum of
    the same bf16 operands (rounded once, the new form is nearer to it)."""
    xdt, wdt = DTYPES[dtypes]
    g = torch.Generator().manual_seed(zlib.crc32(f"{shape}/{layout}/{dtypes}".encode()))
    n_in, n_out = 48, 40
    x = _x(shape, n_in, xdt, g)
    w = _w(layout, n_in, n_out, wdt, g)
    b = (torch.randn(n_out, generator=g) * 0.5).to(wdt)
    got, want = linear(x, w, b), _old(x, w, b)
    assert got.dtype == xdt and got.shape == want.shape == (*x.shape[:-1], n_out)
    if xdt == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
        return
    exact = x.float() @ w.to(xdt).float() + b.to(xdt).float()
    ulp = _bf16_ulp(exact)
    assert (got.float() - want.float()).abs().max().item() <= ulp
    assert (got.float() - exact).abs().max().item() <= ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_in", [False, True])
def test_unbiased_and_int8_paths_are_unchanged(out_in, dtype):
    """Without a bias the product is ``x @ w`` as before, and an
    ``Int8Weight`` (with or without a bias) widens, scales and adds as
    before: bit for bit."""
    g = torch.Generator().manual_seed(3 + out_in)
    x = torch.randn(2, 5, 32, generator=g).to(dtype)
    w = _w("linear_t" if out_in else "conv1d", 32, 24, torch.float32, g)
    assert torch.equal(linear(x, w), x @ w.to(dtype))
    q = torch.randint(-127, 128, (24, 32) if out_in else (32, 24), generator=g,
                      dtype=torch.int8)
    s = torch.rand(24, generator=g) * 0.01
    b = torch.randn(24, generator=g)
    w8 = Int8Weight(q, s, out_in)
    y = (x @ w8.in_out().to(dtype)) * s.to(dtype)
    assert torch.equal(linear(x, w8), y)
    assert torch.equal(linear(x, w8, b), y + b.to(dtype))


@pytest.mark.parametrize("dtypes", ["fp32", "bf16_x_fp32_w"])
@pytest.mark.parametrize("layout", ["conv1d", "linear_t"])
@pytest.mark.parametrize("shape", ["3d", "noncontig"])
def test_gradients_match_the_old_form(shape, layout, dtypes):
    """Under autograd ``x``, ``w`` and ``b`` get the old form's gradients:
    within 1e-5 relative in fp32; within one bf16 ulp of each gradient's
    scale when bf16 ``x`` meets fp32 weights (the mapper trained under
    bf16 compute; the casts' gradients widen back to fp32)."""
    xdt, wdt = DTYPES[dtypes]
    g = torch.Generator().manual_seed(zlib.crc32(f"grad/{shape}/{layout}/{dtypes}".encode()))
    x0 = _x(shape, 48, xdt, g)
    w0 = _w(layout, 48, 40, wdt, g)
    b0 = torch.randn(40, generator=g).to(wdt)
    up = torch.randn(*x0.shape[:-1], 40, generator=g).to(xdt)
    grads = []
    for form in (linear, _old):
        x, w, b = (t.detach().clone().requires_grad_(True) for t in (x0, w0, b0))
        (form(x, w, b).float() * up.float()).sum().backward()
        grads.append((x.grad, w.grad, b.grad))
    for name, got, want in zip("xwb", *grads):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if dtypes == "fp32":
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * want.abs().max().item(), msg=name)
        else:
            assert (got.float() - want.float()).abs().max().item() <= _bf16_ulp(want), name


def test_counters(monkeypatch):
    """``linear.calls`` counts every call; ``linear.bias_in_gemm`` those
    whose bias went into the GEMM (a bias and a dense weight): not an
    unbiased call, not an int8 weight's."""
    monkeypatch.setattr(layers.linear, "calls", 0)
    monkeypatch.setattr(layers.linear, "bias_in_gemm", 0)
    conv, lin, lin_nb = Conv1D(16, 8), Linear(16, 8), Linear(16, 8, bias=False)
    for m in (conv, lin, lin_nb):
        for p in m.parameters():
            p.data = torch.randn(p.shape)
    x = torch.randn(3, 16)
    conv(x), lin(x), lin_nb(x)
    assert (linear.calls, linear.bias_in_gemm) == (3, 2)
    w8 = Int8Weight(torch.ones(16, 8, dtype=torch.int8), torch.ones(8), out_in=False)
    linear(x, w8, torch.zeros(8)), linear(x, conv.weight)
    assert (linear.calls, linear.bias_in_gemm) == (5, 2)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# (rows, in, out, layout) of each biased projection of a cell's blocks.
CARD_SHAPES = {
    **{f"vitl14_b256_{n}": (65_792, k, o, "linear_t") for n, (k, o) in
       {"qkv": (1024, 3072), "out": (1024, 1024), "fc1": (1024, 4096),
        "fc2": (4096, 1024)}.items()},
    **{f"gpt2xl_decode_{n}": (480, k, o, "conv1d") for n, (k, o) in
       {"c_attn": (1600, 4800), "attn_c_proj": (1600, 1600), "c_fc": (1600, 6400),
        "mlp_c_proj": (6400, 1600)}.items()},
    **{f"gpt2_b128_decode_{n}": (640, k, o, "conv1d") for n, (k, o) in
       {"c_attn": (768, 2304), "attn_c_proj": (768, 768), "c_fc": (768, 3072),
        "mlp_c_proj": (3072, 768)}.items()},
    **{f"mapper1600_{n}": (r, k, o, "linear_t") for n, (r, k, o) in
       {"linear": (96, 768, 16_000), "project": (1_920, 1600, 1600),
        "fc1": (1_920, 1600, 3200), "fc2": (1_920, 3200, 1600)}.items()},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: counts kernel launches on the card")
    return torch.device("cuda")


def _kernel_names(fn) -> list:
    """Names of the device kernels one call of ``fn`` launches (``torch.profiler``)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_SHAPES))
def test_biased_linear_is_one_gemm_on_the_card(cuda, case):
    """A bf16 biased ``linear`` launches the GEMM's kernels and nothing
    else: no elementwise add, no copy of the bias; and its output lies
    within one bf16 ulp of the output's scale of the fp32 sum."""
    rows, n_in, n_out, layout = CARD_SHAPES[case]
    g = torch.Generator(device=cuda).manual_seed(rows + n_in + n_out)
    x = torch.randn(rows, n_in, generator=g, device=cuda).bfloat16()
    if layout == "conv1d":
        w = (torch.randn(n_in, n_out, generator=g, device=cuda) * n_in ** -0.5).bfloat16()
    else:
        w = (torch.randn(n_out, n_in, generator=g, device=cuda) * n_in ** -0.5).bfloat16().t()
    b = (torch.randn(n_out, generator=g, device=cuda) * 0.5).bfloat16()
    names = _kernel_names(lambda: linear(x, w, b))
    assert names, "no device kernel traced"
    assert not any("elementwise" in n or "copy" in n.lower() or "fill" in n.lower()
                   for n in names), names
    got = linear(x, w, b).float()
    exact = x.float() @ w.float() + b.float()
    assert (got - exact).abs().max().item() <= _bf16_ulp(exact)


@pytest.mark.cuda
def test_graphed_decode_segment_replays_the_eager_step(cuda):
    """Segments 0 and 1 of a GPT-2 decode step at XL's width (480 rows of
    beam 5; segment 1 holds block 0's ``c_proj``, ``c_fc``, ``c_proj`` and
    block 1's ``c_attn``, every bias non-zero) captured as CUDA graphs
    replay bit-identical to the eager segments, at capture and on new
    inputs; replays call no ``linear`` (the counters count at capture)."""
    from clipcap_tpu_torch.convert import gpt2_from_params
    from clipcap_tpu_torch.models.decoding import EagerSteps, StepGraphs
    from clipcap_tpu_torch.models.gpt2 import GPT2Config, _decode_segment, init_gpt2

    cfg = GPT2Config(vocab_size=64, n_positions=64, n_embd=1600, n_layer=2, n_head=25)
    model = gpt2_from_params(init_gpt2(cfg, seed=5), cfg)
    g = torch.Generator().manual_seed(5)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.data = torch.randn(p.shape, generator=g) * 0.1
    model = model.to(cuda, torch.bfloat16)
    K, R = 5, 96
    steps = StepGraphs(2)

    def segment(i, carry, inp):
        return _decode_segment(model, i, carry, inp, K)

    gd = torch.Generator(device=cuda).manual_seed(6)
    for trial in range(3):
        x = torch.randn(R * K, 1, 1600, generator=gd, device=cuda).bfloat16()
        attn = torch.randn(R, 25, K, 64, generator=gd, device=cuda).bfloat16()
        eager = EagerSteps()
        want0 = eager.run(segment, 0, x)
        want1 = eager.run(segment, 1, attn)
        calls = linear.calls
        got0 = [t.clone() for t in steps.run(segment, 0, x)]
        got1 = steps.run(segment, 1, attn)
        torch.cuda.synchronize()
        if trial:
            assert linear.calls == calls, "a replay called linear"
        for got, want in ((got0, want0), (got1, want1)):
            for a, e in zip(got, want):
                assert torch.equal(a, e), f"trial {trial}"
