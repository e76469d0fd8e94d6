"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the last line):

1. environment: the card, torch and CUDA versions; build the CUDA kernels
   from ``clipcap_tpu_torch/csrc`` and time the build;
2. each kernel against its plain PyTorch twin at the slice's shapes, bf16
   and fp32 (fp32 within 1e-4 abs, bf16 within 2e-2 abs);
3. the captioning slice at full width (CLIP ViT-B/32, the 8-layer
   transformer mapper, GPT-2 124M) with seeded weights, through the public
   entry points: save an ``.npz`` + YAML, ``load(..., device="cuda")``,
   ``get_encoder_from_model``, the mapper, ``generate_beam`` (beam 5) and
   ``generate_nucleus_sampling`` + the CLIP rerank.  Both kernels' launch
   counts must rise over this run, and fp32 beam-5 tokens through the
   kernels must equal those through the twins (a reference run with the
   decode attention patched to the twin, here only);
4. timings (information, not gates): beam-5 captions/s (GPT-2 + mapper in
   bf16, batch 128, 67 new tokens), ViT-B/32 embeds/s (batch 512, uint8),
   each kernel against its twin;
5. a ``torch.profiler`` trace of one batch of each timed workload: wall
   time, device busy time and idle share, kernel launches, and the kernels
   that take the most device time.

Output: one line per finding, then the kernels as one JSON object, then the
card's ``name, power.limit``, then ``{"ok": true, "device": {...}}``.
"""
import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")          # no hub retries offline
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import json  # noqa: E402
import platform  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
P, N_NEW, K = 10, 67, 5           # prefix length, new tokens, beam size


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def host() -> str:
    """What can be seen of the host: host-bound rates move with it.  The CPU
    is named by /proc/cpuinfo where it says, else by its vendor, family and
    model numbers."""
    fields = {}
    cpuinfo = Path("/proc/cpuinfo")
    if cpuinfo.exists():
        for line in cpuinfo.read_text().splitlines():
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    model = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model") if k in fields)
    return (f"CPU {model or 'not reported'}, {os.cpu_count()} logical cores, torch CPU "
            f"capability {torch.backends.cpu.get_cpu_capability()}, host {platform.node()}")


def dispatch_us(dev, n: int = 5000) -> float:
    """Host time per eager op: ``n`` in-place adds on a one-element tensor,
    whose device work is far shorter than their dispatch, so the elapsed
    time is the host's.  The decode loop pays this for each of its ops."""
    x = torch.zeros(1, device=dev)
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches, after warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernels(dev):
    """Phase 2: every kernel against its twin; returns max |Δ| per kernel."""
    from clipcap_tpu_torch.models.gpt2 import beam_mask, causal_bias
    from clipcap_tpu_torch.ops.attention import sdpa_packed, sdpa_packed_ref
    from clipcap_tpu_torch.ops.flash_decode import flash_decode, flash_decode_ref

    g = torch.Generator(device=dev).manual_seed(0)
    err = {"flash_decode": 0.0, "sdpa_packed": 0.0}

    def compare(name, label, dtype, got, want):
        d = (got.float() - want.float()).abs().max().item()
        print(f"kernel {name} {label} {str(dtype)[6:]}: max|d| {d:.3g} (tol {TOL[dtype]})")
        if not d <= TOL[dtype]:
            raise AssertionError(f"{name} {label} {dtype}: max|d| {d} over {TOL[dtype]}")
        err[name] = max(err[name], d)

    for dtype in (torch.float32, torch.bfloat16):
        # Beam 5 at batch 128: the folded-prefix cache (U = 384 slots), the
        # ancestry mask of a random beam history, at early and late steps.
        R, H, U = 128, 12, 384
        q = torch.randn(R, H, K, 64, generator=g, device=dev).to(dtype)
        kv = torch.randn(R, H, U, 128, generator=g, device=dev).to(dtype)
        anc = torch.randint(0, K, (R * K, N_NEW), generator=g, device=dev)
        for step in (0, 1, 30, N_NEW - 1):
            mask = beam_mask(anc, K, U, offset=P + step, cache_base=P)
            u = P + (step + 1) * K
            compare("flash_decode", f"beam R={R} K={K} U={U} u_valid={u}", dtype,
                    flash_decode(q, kv, mask, u), flash_decode_ref(q, kv, mask, u))
        # Sampling (K = 1) at batch 5 with the causal mask (U = 80 slots).
        R, U = 5, 80
        q = torch.randn(R, H, 1, 64, generator=g, device=dev).to(dtype)
        kv = torch.randn(R, H, U, 128, generator=g, device=dev).to(dtype)
        for pos in (P, 40, P + N_NEW - 1):
            mask = causal_bias(1, U, pos, device=dev)[:, 0]
            compare("flash_decode", f"sample R={R} K=1 u_valid={pos + 1}", dtype,
                    flash_decode(q, kv, mask, pos + 1), flash_decode_ref(q, kv, mask, pos + 1))
        for B, N, D, H, causal, label in ((8, 50, 768, 12, False, "ViT-B/32"),
                                          (5, 77, 512, 8, True, "text tower"),
                                          (2, 577, 1024, 16, False, "N=577")):
            qkv = torch.randn(B, N, 3 * D, generator=g, device=dev).to(dtype)
            compare("sdpa_packed", f"{label} B={B} N={N} D={D} causal={causal}", dtype,
                    sdpa_packed(qkv, H, causal=causal), sdpa_packed_ref(qkv, H, causal=causal))
    torch.cuda.synchronize()
    return err


def time_kernels(dev, tag: str):
    """Phase 4a: kernel vs twin device time at the slice's bf16 shapes."""
    from clipcap_tpu_torch.models.gpt2 import beam_mask
    from clipcap_tpu_torch.ops.attention import sdpa_packed, sdpa_packed_ref
    from clipcap_tpu_torch.ops.flash_decode import flash_decode, flash_decode_ref

    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    out = {}
    R, H, U, step = 128, 12, 384, 40
    q = torch.randn(R, H, K, 64, generator=g, device=dev).to(bf)
    kv = torch.randn(R, H, U, 128, generator=g, device=dev).to(bf)
    anc = torch.randint(0, K, (R * K, N_NEW), generator=g, device=dev)
    mask = beam_mask(anc, K, U, offset=P + step, cache_base=P)
    u = P + (step + 1) * K
    out["flash_decode"] = (cuda_ms(lambda: flash_decode(q, kv, mask, u)),
                           cuda_ms(lambda: flash_decode_ref(q, kv, mask, u)))
    print(f"time [{tag}] flash_decode beam R={R} H={H} K={K} u_valid={u} bf16: kernel "
          f"{out['flash_decode'][0]:.4f} ms, twin {out['flash_decode'][1]:.4f} ms")
    for B, N, D, H, causal, label in ((512, 50, 768, 12, False, "ViT-B/32 b512"),
                                      (5, 77, 512, 8, True, "text tower b5")):
        qkv = torch.randn(B, N, 3 * D, generator=g, device=dev).to(bf)
        t = (cuda_ms(lambda: sdpa_packed(qkv, H, causal=causal)),
             cuda_ms(lambda: sdpa_packed_ref(qkv, H, causal=causal)))
        out.setdefault("sdpa_packed", t)
        print(f"time [{tag}] sdpa_packed {label} bf16: kernel {t[0]:.4f} ms, "
              f"twin {t[1]:.4f} ms")
    return out


def run_slice(dev, workdir: Path):
    """Phase 3: the captioning slice through the public entry points."""
    from PIL import Image

    from clipcap_tpu_torch import generate_beam, generate_nucleus_sampling, get_encoder_from_model
    from clipcap_tpu_torch import load
    from clipcap_tpu_torch.config import Config, EncoderConfig, save_yaml_config
    from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
    from clipcap_tpu_torch.models import gpt2
    from clipcap_tpu_torch.models.clipcap import init_clipcap
    from clipcap_tpu_torch.ops.attention import sdpa_packed
    from clipcap_tpu_torch.ops.flash_decode import flash_decode, flash_decode_ref
    from clipcap_tpu_torch.train.checkpoint import save_params

    image = workdir / "image.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (224, 224, 3), dtype=np.uint8)
                    ).save(image)
    config = Config(language_model="gpt2", prefix_length=P, projection_length=P,
                    transformer_layers=8, transformer_attention_heads=8,
                    encoder_config=EncoderConfig(encoder_model_name="clip",
                                                 encoder_model_variant="ViT-B/32",
                                                 encoder_embedding_size=512))
    t0 = time.perf_counter()
    save_params(str(workdir / "model.npz"), init_clipcap(config, seed=0).params())
    save_yaml_config(config, str(workdir / "config.yaml"))
    print(f"slice: seeded full-width model saved in {time.perf_counter() - t0:.1f} s")

    model, tokenizer = load(str(workdir / "model.npz"), str(workdir / "config.yaml"),
                            device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")               # seeded CLIP: no checkpoint offline
        encoder, transform = get_encoder_from_model(model)

    flash_decode.launches = 0
    sdpa_packed.launches = 0
    t0 = time.perf_counter()
    sample = transform(str(image))
    embedding = encoder(sample[None])
    prefix = model.transformer_mapper(embedding)
    beams = generate_beam(model, tokenizer, prefix, number_to_generate=5, beam_size=K)
    captions = generate_nucleus_sampling(model, tokenizer, prefix, number_to_generate=5,
                                         top_p=0.9)
    sims = encoder.similarity(sample, captions)
    torch.cuda.synchronize()
    launches = {"flash_decode": flash_decode.launches, "sdpa_packed": sdpa_packed.launches}
    print(f"slice: image -> {len(beams)} beam-5 + {len(captions)} nucleus captions + rerank "
          f"in {time.perf_counter() - t0:.2f} s; launches {launches}")

    if embedding.shape != (1, 512) or not np.isfinite(embedding).all():
        raise AssertionError(f"bad image embedding {embedding.shape}")
    if prefix.shape != (1, P, 768) or not torch.isfinite(prefix).all():
        raise AssertionError(f"bad prefix {tuple(prefix.shape)}")
    if len(beams) != 5 or len(captions) != 5 or sims.shape != (5,) or not np.isfinite(sims).all():
        raise AssertionError("bad captions or similarities")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the slice never launched the {name} kernel")
    print(f"slice: best beam {beams[0]!r}; rerank sims {np.round(sims, 3).tolist()}")

    # fp32 beam 5 through the kernels == through the twins, token for token.
    # The reference run patches GPT-2's decode attention to the twin for
    # its duration; the port itself has no switch that skips the kernel.
    bp = BeamParams(beam_size=K, max_new_tokens=N_NEW, stop_token=tokenizer.eos_token_id)
    pre = prefix.float()
    n0 = flash_decode.launches
    kern = beam_search_batched(model.language_model, pre, bp, dtype=torch.float32)
    n1 = flash_decode.launches
    with mock.patch.object(gpt2, "flash_decode", flash_decode_ref):
        twin = beam_search_batched(model.language_model, pre, bp, dtype=torch.float32)
    if n1 == n0 or flash_decode.launches != n1:
        raise AssertionError("the kernel run must launch flash_decode and the twin run not")
    if not torch.equal(kern.tokens, twin.tokens):
        raise AssertionError("fp32 beam-5 tokens differ between kernels and twins")
    print(f"slice: fp32 beam-5 tokens kernels ({n1 - n0} launches) == twins (0 launches), "
          f"{kern.tokens.numel()} tokens; max|d score| "
          f"{(kern.scores - twin.scores).abs().max().item():.3g}")
    return model, encoder, launches


def rate(work, inputs, per_input: int, trials: int = 3):
    """Items/s of ``work`` over ``inputs``, one value per trial (bench.py's
    method: warm-up, distinct inputs per round, synchronise before the
    clock stops)."""
    for x in inputs[:2]:
        work(x)
    torch.cuda.synchronize()
    per_trial = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for x in inputs:
            work(x)
        torch.cuda.synchronize()
        per_trial.append(per_input * len(inputs) / (time.perf_counter() - t0))
    return per_trial


def beam_workload(model, dev, batch=128, rounds=3):
    """Beam-5 captions: mapper + GPT-2 in bf16, distinct embeddings per round."""
    import copy

    from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched

    lm = copy.deepcopy(model.language_model).to(torch.bfloat16)
    mapper = copy.deepcopy(model.transformer_mapper).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(0)
    inputs = [torch.randn(batch, 512, generator=g, device=dev) for _ in range(rounds)]
    bp = BeamParams(beam_size=K, max_new_tokens=N_NEW, stop_token=50256)

    def caption(x):
        return beam_search_batched(lm, mapper(x, dtype=torch.bfloat16), bp, dtype=torch.bfloat16)

    return caption, inputs


def vit_workload(encoder, dev, batch=512, rounds=4):
    """ViT-B/32 embeddings: bf16 weights, uint8 images, distinct per round."""
    import copy

    from clipcap_tpu_torch.models.clip_vit import clip_encode_image

    visual = copy.deepcopy(encoder.model.visual).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(0)
    inputs = [torch.randint(0, 256, (batch, 224, 224, 3), generator=g, device=dev,
                            dtype=torch.uint8) for _ in range(rounds)]

    @torch.no_grad()
    def embed(x):
        return clip_encode_image(visual, x, dtype=torch.bfloat16)

    return embed, inputs


def profile(work, x, batch_ms: float, label: str, tag: str, top: int = 8):
    """Phase 5: one call of ``work(x)`` under torch.profiler.  Prints the
    wall time, the device busy time (sum of kernel times: one stream), the
    idle share against the unprofiled batch time, the kernel count and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    if busy_ms == 0:
        print(f"profile [{tag}] {label}: wall {wall_ms:.1f} ms; device time not measured "
              "(the trace holds no device events)")
        return
    print(f"profile [{tag}] {label}: wall {wall_ms:.1f} ms under the profiler, "
          f"{batch_ms:.1f} ms without; device busy {busy_ms:.1f} ms; idle share "
          f"{1 - busy_ms / batch_ms:.3f} of the unprofiled batch; "
          f"{sum(e.count for e in kernels)} kernels")
    for e in sorted(kernels, key=device_us, reverse=True)[:top]:
        print(f"profile [{tag}] {label}:   {device_us(e) / 1e3:8.2f} ms {e.count:6d}x "
              f"{e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 means fp32 for the parity checks
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name_limit = card()
    host_line = host()
    print(f"card: {name_limit}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; {host_line}")

    from clipcap_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernels: built {_build.library_path().relative_to(ROOT)} from "
          f"{[str(s.relative_to(ROOT)) for s in _build.sources()]} in "
          f"{time.perf_counter() - t0:.1f} s")

    errors = check_kernels(dev)
    build_root = ROOT / "build" / "clipcap_tpu_torch"
    build_root.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as tmp:
        model, encoder, launches = run_slice(dev, Path(tmp))
    times = time_kernels(dev, name_limit)
    beam, beam_inputs = beam_workload(model, dev)
    beam_cps = rate(beam, beam_inputs, 128)
    print(f"time [{name_limit}] beam-5 GPT-2 b128 bf16 ({N_NEW} new tokens): captions/s "
          f"per trial {beam_cps}")
    vit, vit_inputs = vit_workload(encoder, dev)
    embeds = rate(vit, vit_inputs, 512)
    print(f"time [{name_limit}] ViT-B/32 b512 bf16 uint8: embeds/s per trial {embeds}")
    print(f"host: {dispatch_us(dev)} us of host time per eager op (one-element add)")
    print(f"summary [{name_limit}; {host_line}]: beam-5 GPT-2 b128 bf16 median "
          f"{statistics.median(beam_cps):.1f} captions/s of {len(beam_cps)} trials; "
          f"ViT-B/32 b512 bf16 median {statistics.median(embeds):.1f} embeds/s of "
          f"{len(embeds)} trials; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile(beam, beam_inputs[0], 128e3 / statistics.median(beam_cps), "beam-5 GPT-2 b128",
            name_limit)
    profile(vit, vit_inputs[0], 512e3 / statistics.median(embeds), "ViT-B/32 b512", name_limit)
    if "jax" in sys.modules:
        raise AssertionError("the port loaded jax")

    kernels = [
        {"name": "flash_decode", "route": "cuda",
         "source": "clipcap_tpu_torch/csrc/flash_decode.cu",
         "replaces": "clipcap_tpu/ops/flash_decode.py:407",
         "launches": launches["flash_decode"], "max_abs_err": errors["flash_decode"],
         "ms": times["flash_decode"][0], "plain_ms": times["flash_decode"][1]},
        {"name": "sdpa_packed", "route": "cuda",
         "source": "clipcap_tpu_torch/csrc/sdpa_packed.cu",
         "replaces": "clipcap_tpu/ops/attention.py:244",
         "launches": launches["sdpa_packed"], "max_abs_err": errors["sdpa_packed"],
         "ms": times["sdpa_packed"][0], "plain_ms": times["sdpa_packed"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(name_limit)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
