"""``ops/layers.py::layer_norm`` on the card: one ATen ``layer_norm`` launch.

The CPU tests of the function (the fp32 formula, one bf16 ulp, the
gradients) are in ``test_torch_ops.py``; graphed GPT-2 beam steps, whose
dense segments hold ``ln_1``, ``ln_2`` and ``ln_f``, are held to the eager
segments bit for bit in ``test_torch_decode_graphs.py`` (bf16 weights, and
fp32 ones under bf16 compute).  The file imports no JAX: run it with
``python -m pytest tests/test_torch_layer_norm.py --noconftest -m cuda -q``.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clipcap_tpu_torch.ops.layers import layer_norm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: counts kernel launches on the card")
    return torch.device("cuda")


def _kernels(fn) -> int:
    """Device kernels launched by one call of ``fn``, by ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


@pytest.mark.cuda
@pytest.mark.parametrize("weights,most", [(torch.bfloat16, 2), (torch.float32, 4)])
def test_layer_norm_launches_once_or_thrice(cuda, weights, most):
    """A bf16 [480, 1600] input (a GPT-2 XL beam step's rows): at most 2
    kernels with bf16 weights (one is ATen's ``layer_norm``), at most 4
    with fp32 weights (widen, norm, narrow); within one bf16 ulp of the
    fp32 norm rounded once."""
    g = torch.Generator(device=cuda).manual_seed(20)
    x = torch.randn(480, 1600, generator=g, device=cuda).bfloat16()
    scale = (torch.randn(1600, generator=g, device=cuda) * 0.2 + 1).to(weights)
    bias = (torch.randn(1600, generator=g, device=cuda) * 0.2).to(weights)
    assert _kernels(lambda: layer_norm(x, scale, bias)) <= most
    got = layer_norm(x, scale, bias)
    want = torch.nn.functional.layer_norm(x.float(), (1600,), scale.float(), bias.float(),
                                          1e-5).bfloat16()
    assert got.dtype == torch.bfloat16
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0 ** -13))) - 7)
    assert bool(((got.float() - want.float()).abs() <= ulp).all())
