"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the last line):

1. environment: the card, torch and CUDA versions; build the CUDA kernels
   from ``clipcap_tpu_torch/csrc`` and time the build;
2. each kernel against its plain PyTorch twin at the slice's shapes, bf16
   and fp32 (fp32 within 1e-4 abs, bf16 within 2e-2 abs); the int8 and
   two-phase decode kernels at GPT-2 XL beam-5 shapes (R = 96, H = 25,
   K = 5): the int8 folded cache, per-row bounds, the carry, and bf16/fp32
   or int8 shared + live regions with a random per-sample converged length;
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
   that take the most device time;
6. training at full width (GPT-2 124M, the 8-layer mapper, 512-d
   embeddings) on a seeded dataset of 650 rows written in the preprocess
   stage's layout, through ``clipcap_tpu_torch.train``'s entry point:
   (a) prefix-only and (b) mapper + GPT-2, bf16, batch 64, the fused-AdamW
   kernel, one epoch.  Gates: finite losses, ``fused_adamw.launches`` up by
   at least the step count in each run, the final ``.npz`` loads on the
   card and captions an embedding; the kernel against its twin at the
   full-finetune parameter set (bit for bit), and three fp32 full-finetune
   steps through the kernel against the same steps through the twin
   (parameters within 0.01·Σlr).  Information: ms per train step and
   samples/s of (a) and (b), kernel and twin ms, and a ``torch.profiler``
   breakdown of one full-finetune step;
7. GPT-2 XL beam 5 with an int8 KV cache and converged-prefix
   consolidation: a seeded GPT-2 XL + 8-layer mapper on the card.  Gates
   at fp32, R = 4, 67 new tokens: with the bf16/fp32 cache form at C = 8
   the tokens through the kernels equal those through the twins, and equal
   C = 0's; with the int8 cache (C = 0 and C = 8) every decode attention
   call runs the kernel and its twin in lockstep on the same inputs, within
   1e-4 (``xl_gates`` says why tokens are not the gate there); then the
   main path with every count set to 0 just
   before: ``--int8-kv-cache`` through the inference CLI's function on the
   GPT-2 124M checkpoint of phase 3, ``generate_beam(int8_kv=True)`` and
   ``beam_search_batched`` b96 with ``consolidate_every=8`` (bf16 and int8
   caches) must launch both new kernels.  Information: captions/s and peak
   device memory of (bf16|int8, C=0|8) at b96 bf16, a ``torch.profiler``
   breakdown of the (int8, C=0) batch, each new kernel against its twin
   and its bound.

Every kernel's row carries its bound (bytes over 3.35 TB/s or operations
over the data sheet's peak, whichever is larger) and the time of one
PyTorch call that computes the same function, where there is one.

Output: one line per finding, then the kernels as one JSON object, then the
card's ``name, power.limit``, then ``{"ok": true, "device": {...}}``.
"""
import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")          # no hub retries offline
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import contextlib  # noqa: E402
import copy  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import platform  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
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
XL_BATCH, XL_HEADS = 96, 25       # GPT-2 XL beam-5 batch (bench.py's), heads
TRAIN_ROWS, TRAIN_BATCH, EMB = 650, 64, 512    # 11 steps, the last one padded
MODEL_ARGS = ["--language-model", "gpt2", "--prefix-length", str(P), "--projection-length",
              str(P), "--transformer-layers", "8", "--transformer-attention-heads", "8"]


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
    err = {"flash_decode": 0.0, "sdpa_packed": 0.0, "flash_decode_int8": 0.0,
           "flash_decode_two_phase": 0.0}

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
        check_kv_kernels(dev, g, dtype, compare)
    torch.cuda.synchronize()
    return err


def int8_cache(g, R, H, U, dev):
    """Seeded int8 K|V rows [R, H, U, 128] and their fp32 (sk, sv) scales;
    values stay under 1.9 in magnitude, so a bf16 output's last place is at
    most 2^-7 and the 2e-2 tolerance holds a rounding or two."""
    rows = torch.randint(-127, 128, (R, H, U, 128), generator=g, device=dev).to(torch.int8)
    sk = torch.rand(R, H, U, generator=g, device=dev) * 0.01 + 0.005
    sv = torch.rand(R, H, U, generator=g, device=dev) * 0.01 + 0.005
    return rows, (sk, sv)


def region(g, R, H, U, dtype, int8: bool, dev):
    """One decode cache region: (rows, scales or None)."""
    if int8:
        return int8_cache(g, R, H, U, dev)
    return torch.randn(R, H, U, 128, generator=g, device=dev).to(dtype), None


def two_phase_inputs(g, dtype, step: int, sh_int8: bool, lv_int8: bool, dev, R=XL_BATCH):
    """GPT-2 XL beam-5 consolidated step ``step``: shared (80 / 128 slots)
    and live (336 / 384) regions, a random per-sample converged length c
    in [P, P + step], the masks gpt2_apply builds.  → (args, kwargs) of
    ``flash_decode_two_phase``."""
    from clipcap_tpu_torch.models.gpt2 import beam_mask, shared_mask

    H = XL_HEADS
    Us, Ul = (128 if sh_int8 else 80), (384 if lv_int8 else 336)
    q = torch.randn(R, H, K, 64, generator=g, device=dev).to(dtype)
    sh, sh_s = region(g, R, H, Us, dtype, sh_int8, dev)
    lv, lv_s = region(g, R, H, Ul, dtype, lv_int8, dev)
    c = P + torch.randint(0, step + 1, (R,), generator=g, device=dev).to(torch.int32)
    anc = torch.randint(0, K, (R * K, N_NEW), generator=g, device=dev)
    lv_mask = beam_mask(anc, K, Ul, offset=P + step, cache_base=P, shared_len=c)
    args = (q, sh, shared_mask(c, K, Us, dev), lv, lv_mask, c, ((c - P) * K).to(torch.int32),
            (step + 1) * K)
    return args, dict(shared_scales=sh_s, live_scales=lv_s)


def check_kv_kernels(dev, g, dtype, compare):
    """Phase 2, the int8 and two-phase decode kernels at GPT-2 XL beam-5
    shapes (R = 96, H = 25, K = 5): the int8 folded cache (U = 384) at
    early, middle and late steps, per-row bounds and the carry; the
    two-phase kernel over bf16/fp32 or int8 shared + live regions with a
    random per-sample converged length; the int8 sampling cache (K = 1)."""
    from clipcap_tpu_torch.models.gpt2 import beam_mask, causal_bias
    from clipcap_tpu_torch.ops.flash_decode import (flash_decode, flash_decode_ref,
                                                    flash_decode_two_phase,
                                                    flash_decode_two_phase_ref)

    R, H, U = XL_BATCH, XL_HEADS, 384
    q = torch.randn(R, H, K, 64, generator=g, device=dev).to(dtype)
    rows, scales = int8_cache(g, R, H, U, dev)
    anc = torch.randint(0, K, (R * K, N_NEW), generator=g, device=dev)
    for step in (0, 1, 40, N_NEW - 1):
        mask = beam_mask(anc, K, U, offset=P + step, cache_base=P)
        u = P + (step + 1) * K
        compare("flash_decode_int8", f"beam R={R} H={H} K={K} U={U} u_valid={u}", dtype,
                flash_decode(q, rows, mask, u, scales=scales),
                flash_decode_ref(q, rows, mask, u, scales=scales))
    lo = torch.randint(0, 150, (R,), generator=g, device=dev).to(torch.int32)
    hi = (lo + torch.randint(1, 235, (R,), generator=g, device=dev)).to(torch.int32)
    compare("flash_decode_int8", f"per-row [lo, hi) R={R}", dtype,
            flash_decode(q, rows, mask, hi, scales=scales, u_lo=lo),
            flash_decode_ref(q, rows, mask, hi, scales=scales, u_lo=lo))
    part = flash_decode(q, rows, mask, 100, scales=scales, return_carry=True)
    part_ref = flash_decode_ref(q, rows, mask, 100, scales=scales, return_carry=True)
    for name, a, b in zip(("m", "l"), part, part_ref):
        d = ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()
        print(f"kernel flash_decode_int8 carry {name} {str(dtype)[6:]}: max rel|d| {d:.3g}")
        if not d <= 1e-4:
            raise AssertionError(f"flash_decode_int8 carry {name}: {d}")
    compare("flash_decode_int8", "carry acc / l over [0, 100)", dtype,
            part[2] / part[1][..., None], part_ref[2] / part_ref[1][..., None])
    compare("flash_decode_int8", "carry [0, 100) resumed over [100, 384)", dtype,
            flash_decode(q, rows, mask, U, scales=scales, u_lo=100, carry=part),
            flash_decode_ref(q, rows, mask, U, scales=scales))
    # Sampling (K = 1) over the int8 cache of the nucleus demo (128 slots).
    q1 = torch.randn(5, 12, 1, 64, generator=g, device=dev).to(dtype)
    rows1, scales1 = int8_cache(g, 5, 12, 128, dev)
    for pos in (P, P + N_NEW - 1):
        mask = causal_bias(1, 128, pos, device=dev)[:, 0]
        compare("flash_decode_int8", f"sample R=5 K=1 u_valid={pos + 1}", dtype,
                flash_decode(q1, rows1, mask, pos + 1, scales=scales1),
                flash_decode_ref(q1, rows1, mask, pos + 1, scales=scales1))
    for sh_int8, lv_int8 in ((False, False), (True, True), (True, False), (False, True)):
        for step in (0, 40, N_NEW - 1):
            args, kw = two_phase_inputs(g, dtype, step, sh_int8, lv_int8, dev)
            compare("flash_decode_two_phase",
                    f"R={R} H={H} K={K} shared int8={sh_int8} live int8={lv_int8} "
                    f"U={args[1].shape[2]}+{args[3].shape[2]} step={step}", dtype,
                    flash_decode_two_phase(*args, **kw), flash_decode_two_phase_ref(*args, **kw))


# The H100 SXM's published peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}   # fp32: CUDA cores


def bound(nbytes: float, ops: float, dtype) -> dict:
    """The least time the card could take for a call: its bytes (each input
    read once, each output written once) over the memory rate, or its
    operations over the peak rate of ``dtype``, whichever is larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def decode_bound(q, regions, dtype) -> dict:
    """Bound of one decode-attention call: ``regions`` lists (slots read per
    head summed over rows, bytes per slot and head, mask columns read summed
    over rows); q is read and the output written once; 4·Dh·K operations
    per slot and head (q·k and w·v)."""
    R, H, Kq, Dh = q.shape
    nbytes = 2 * q.numel() * q.element_size()
    ops = 0
    for slots, slot_bytes, mask_cols in regions:
        nbytes += H * slots * slot_bytes + Kq * mask_cols * 4
        ops += H * slots * 4 * Dh * Kq
    return bound(nbytes, ops, dtype)


def time_kernels(dev, tag: str):
    """Phase 4a: kernel vs twin vs one PyTorch call, device time at the
    slice's bf16 shapes, and each kernel's bound."""
    import torch.nn.functional as F

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
    lib_mask = mask[:, None, :, :u].to(bf)
    out["flash_decode"] = {
        "ms": cuda_ms(lambda: flash_decode(q, kv, mask, u)),
        "plain_ms": cuda_ms(lambda: flash_decode_ref(q, kv, mask, u)),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, kv[:, :, :u, :64], kv[:, :, :u, 64:], attn_mask=lib_mask)),
        **decode_bound(q, [(R * u, 256, R * u)], bf)}
    print(f"time [{tag}] flash_decode beam R={R} H={H} K={K} u_valid={u} bf16: "
          f"{out['flash_decode']}")
    for B, N, D, H, causal, label in ((512, 50, 768, 12, False, "ViT-B/32 b512"),
                                      (5, 77, 512, 8, True, "text tower b5")):
        qkv = torch.randn(B, N, 3 * D, generator=g, device=dev).to(bf)
        heads = qkv.view(B, N, 3, H, D // H).permute(2, 0, 3, 1, 4)
        t = {"ms": cuda_ms(lambda: sdpa_packed(qkv, H, causal=causal)),
             "plain_ms": cuda_ms(lambda: sdpa_packed_ref(qkv, H, causal=causal)),
             "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                 *heads, is_causal=causal)),
             **bound(4 * B * N * D * 2, 4 * B * N * N * D, bf)}
        out.setdefault("sdpa_packed", t)
        print(f"time [{tag}] sdpa_packed {label} bf16: {t}")
    return out


def time_kv_kernels(dev, tag: str):
    """Phase 7d: the int8 and two-phase decode kernels at GPT-2 XL beam-5
    step 40 (b96, bf16 q): kernel vs twin device time and each bound.  No
    single PyTorch call computes either function."""
    from clipcap_tpu_torch.models.gpt2 import beam_mask
    from clipcap_tpu_torch.ops.flash_decode import (flash_decode, flash_decode_ref,
                                                    flash_decode_two_phase,
                                                    flash_decode_two_phase_ref)

    g = torch.Generator(device=dev).manual_seed(3)
    bf, step = torch.bfloat16, 40
    R, H, U = XL_BATCH, XL_HEADS, 384
    q = torch.randn(R, H, K, 64, generator=g, device=dev).to(bf)
    rows, scales = int8_cache(g, R, H, U, dev)
    anc = torch.randint(0, K, (R * K, N_NEW), generator=g, device=dev)
    mask = beam_mask(anc, K, U, offset=P + step, cache_base=P)
    u = P + (step + 1) * K
    out = {"flash_decode_int8": {
        "ms": cuda_ms(lambda: flash_decode(q, rows, mask, u, scales=scales)),
        "plain_ms": cuda_ms(lambda: flash_decode_ref(q, rows, mask, u, scales=scales)),
        "library_ms": None, **decode_bound(q, [(R * u, 136, R * u)], bf)}}
    print(f"time [{tag}] flash_decode_int8 beam R={R} H={H} K={K} u_valid={u} bf16 q: "
          f"{out['flash_decode_int8']}")
    for int8 in (False, True):
        args, kw = two_phase_inputs(g, bf, step, int8, int8, dev)
        c, lv_lo, lv_hi = args[5], args[6], args[7]
        shared_slots = int((c.sum()).item())
        live_slots = int((lv_hi - lv_lo).sum().item())
        slot_bytes = 136 if int8 else 256
        t = {"ms": cuda_ms(lambda: flash_decode_two_phase(*args, **kw)),
             "plain_ms": cuda_ms(lambda: flash_decode_two_phase_ref(*args, **kw)),
             "library_ms": None,
             **decode_bound(q, [(shared_slots, slot_bytes, shared_slots),
                                (live_slots, slot_bytes, live_slots)], bf)}
        print(f"time [{tag}] flash_decode_two_phase R={R} H={H} K={K} step {step} int8={int8} "
              f"({shared_slots} shared + {live_slots} live slots over the rows): {t}")
        out.setdefault("flash_decode_two_phase", t)
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
    from clipcap_tpu_torch.models.gpt2 import get_gpt2_config
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
    # Seeded GPT-2 even where HF weights sit on disk (init_clipcap without
    # lm_config would load them).
    model = init_clipcap(config, lm_config=get_gpt2_config("gpt2"), seed=0)
    save_params(str(workdir / "model.npz"), model.params())
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


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def train_config():
    from clipcap_tpu_torch.config import Config, EncoderConfig

    return Config(language_model="gpt2", prefix_length=P, projection_length=P,
                  transformer_layers=8, transformer_attention_heads=8,
                  encoder_config=EncoderConfig(encoder_model_name="clip",
                                               encoder_model_variant="ViT-B/32",
                                               encoder_embedding_size=EMB))


def write_train_dataset(root: Path, rows: int = TRAIN_ROWS, dim: int = EMB, seed: int = 0):
    """Phase 6a: seeded fp32 embeddings and captions of 8-80 bytes (8-80
    tokens under the byte tokenizer used offline) in two partitions, with
    the preprocess stage's JAX-free writer."""
    from clipcap_tpu_torch.preprocess.writer import PartitionWriter, write_encoder_config
    from clipcap_tpu_torch.utils.tokenizer import get_tokenizer

    rng = np.random.default_rng(seed)
    words = ("a man woman dog cat red blue small large sits stands near on the of with "
             "street park table window car tree field beach two three playing holding").split()
    captions = []
    for _ in range(rows):
        n = int(rng.integers(8, 81))
        text = ""
        while len(text) < n:
            text += str(rng.choice(words)) + " "
        captions.append(text[:n - 1] + ".")
    embeds = rng.standard_normal((rows, dim)).astype(np.float32)
    write_encoder_config(train_config().encoder_config, str(root))
    for i, (lo, hi) in enumerate(((0, 400), (400, rows))):
        writer = PartitionWriter(i, str(root), 2)
        writer({"embeddings": embeds[lo:hi], "text": captions[lo:hi]})
        writer.flush()
    lengths = [len(t) for t in get_tokenizer("gpt2").batch_encode_plus(captions)["input_ids"]]
    print(f"train: dataset of {rows} rows x {dim} fp32, captions of {min(lengths)}-"
          f"{max(lengths)} tokens, {sum(n > 64 for n in lengths)} cut at 64")
    return embeds


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)
        return len(text)


def train_cli(dev, root: Path, out: Path, label: str, extra, embedding, model_args=MODEL_ARGS):
    """Phase 6b: one run of ``clipcap_tpu_torch.train``'s entry point on
    the card, then its final checkpoint through ``load`` and
    ``generate_beam``.  Returns the fused-AdamW launches of the run."""
    from clipcap_tpu_torch import generate_beam, load
    from clipcap_tpu_torch.ops.fused_adamw import fused_adamw
    from clipcap_tpu_torch.train.train import start_training

    device = "cpu" if torch.device(dev).type == "cpu" else str(torch.device(dev).index or 0)
    argv = ["--device", device, "--input-dataset", str(root), "--output-folder", str(out),
            "--fp-precision", "16", "--batch-size", str(TRAIN_BATCH), "--fused-optimizer",
            "true", "--scheduler-warmup-steps", "2", "--epochs", "1",
            "--logging-frequency", "1", *model_args, *extra]
    log = io.StringIO()
    fused_adamw.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(), contextlib.redirect_stdout(_Tee(sys.stdout, log)):
        warnings.simplefilter("ignore")               # seeded GPT-2: no weights offline
        rc = start_training(argv)
    sync(dev)
    launches = fused_adamw.launches
    seconds = time.perf_counter() - t0
    losses = [float(x) for x in re.findall(r" loss (\S+) ", log.getvalue())]
    steps = math.ceil(TRAIN_ROWS / TRAIN_BATCH)
    print(f"train ({label}): exit {rc} in {seconds:.1f} s (model build, {len(losses)} steps, "
          f"checkpoints); losses {[round(x, 4) for x in losses]}; fused_adamw launches "
          f"{launches}")
    if rc != 0 or len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train ({label}): exit {rc}, losses {losses}")
    if launches < steps:
        raise AssertionError(f"train ({label}): {launches} fused_adamw launches for {steps} steps")
    names = sorted(os.listdir(out))
    if names != ["clipcap_config.yaml", "clipcap_epoch_0.npz", "clipcap_final.npz"]:
        raise AssertionError(f"train ({label}): wrote {names}")
    model, tokenizer = load(str(out / "clipcap_final.npz"), str(out / "clipcap_config.yaml"),
                            device=dev)
    prefix = model.transformer_mapper(embedding[None])
    caption = generate_beam(model, tokenizer, prefix, number_to_generate=1, beam_size=K)
    if len(caption) != 1 or not isinstance(caption[0], str) or not torch.isfinite(prefix).all():
        raise AssertionError(f"train ({label}): the final checkpoint did not caption")
    print(f"train ({label}): final checkpoint loaded on {dev} and captioned: {caption[0]!r}")
    return launches


def check_adamw(model, dev, tag: str):
    """Phase 6c: the kernel against its twin on the full-finetune parameter
    set (every tensor of GPT-2 + mapper), one step from identical inputs:
    bit for bit (tolerance 0).  Then kernel and twin device time."""
    from clipcap_tpu_torch.ops.fused_adamw import adamw_scalars, fused_adamw, fused_adamw_ref

    g = torch.Generator(device=dev).manual_seed(2)
    params = [p.detach().to(dev, copy=True) for p in model.parameters()]
    grads = [torch.randn(p.shape, generator=g, device=dev) for p in params]
    mu = [torch.randn(p.shape, generator=g, device=dev) * 1e-2 for p in params]
    nu = [torch.rand(p.shape, generator=g, device=dev) * 1e-4 for p in params]
    twin = [[t.clone() for t in group] for group in (params, grads, mu, nu)]
    s = adamw_scalars(1e-4, 0.9, 0.999, 1e-8, 0.01, count=3)
    fused_adamw(params, grads, mu, nu, s)
    fused_adamw_ref(*twin, s)
    sync(dev)
    err = max((a - b).abs().max().item() for got, want in zip((params, mu, nu),
                                                               (twin[0], twin[2], twin[3]))
              for a, b in zip(got, want))
    n = sum(p.numel() for p in params)
    print(f"kernel fused_adamw full finetune ({len(params)} tensors, {n} elements) fp32: "
          f"max|d| {err:.3g} (tol 0: bit for bit)")
    if err != 0:
        raise AssertionError(f"fused_adamw differs from its twin by {err}")
    # The library yardstick: PyTorch's multi-tensor AdamW (its own op order:
    # bias corrections on lr and the denominator, decay before the update).
    steps = [torch.tensor(3.0, device=dev) for _ in params]
    times = {"ms": cuda_ms(lambda: fused_adamw(params, grads, mu, nu, s)),
             "plain_ms": cuda_ms(lambda: fused_adamw_ref(*twin, s)),
             "library_ms": cuda_ms(lambda: torch._fused_adamw_(
                 twin[0], twin[1], twin[2], twin[3], [], steps, lr=1e-4, beta1=0.9,
                 beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False)),
             # 28 bytes per element (p, g, m, v read; p, m, v written), ~16 fp32 ops
             **bound(28 * n, 16 * n, torch.float32)}
    print(f"time [{tag}] fused_adamw {len(params)} tensors, {n} elements: {times} "
          f"({28 * n / times['ms'] / 1e6:.1f} GB/s at 28 bytes per element)")
    return err, times


def three_steps(base, dev, batches):
    """Phase 6d: three fp32 full-finetune steps on identical batches, once
    through the kernel and once with the optimizer patched to the twin
    (here only; the port has no switch).  Parameters must agree within
    0.01·Σlr: a tensor the kernel skipped, or a wrong update, moves by
    about lr."""
    from clipcap_tpu_torch.ops.fused_adamw import fused_adamw, fused_adamw_ref
    from clipcap_tpu_torch.train import state as state_mod
    from clipcap_tpu_torch.train.step import train_step

    runs = []
    for patched in (False, True):
        model = copy.deepcopy(base).to(dev)
        tx = state_mod.make_optimizer(1e-4, 1, 3, train_language_model=True, fused=True)
        st = state_mod.create_train_state(model, tx)
        n0 = fused_adamw.launches
        patch = (mock.patch.object(state_mod, "fused_adamw", fused_adamw_ref) if patched
                 else contextlib.nullcontext())
        with patch:
            for tokens, embeds in batches[:3]:
                train_step(st, tokens, embeds, tx=tx, dtype=torch.float32, remat=True)
        sync(dev)
        runs.append((model, fused_adamw.launches - n0))
        sum_lr = sum(tx.schedule(i) for i in range(3))
    (kern, n_kern), (twin, n_twin) = runs
    if n_kern != 3 or n_twin != 0:
        raise AssertionError(f"kernel run launched {n_kern}, twin run {n_twin}")
    diffs = [(a - b).abs() for a, b in zip(kern.parameters(), twin.parameters())]
    d = max(x.max().item() for x in diffs)
    unequal = sum(int((x != 0).sum()) for x in diffs)
    total = sum(x.numel() for x in diffs)
    print(f"train: 3 fp32 full-finetune steps, kernel ({n_kern} launches) vs twin (0): "
          f"max|d param| {d:.3g} (bound 0.01 x sum lr = {0.01 * sum_lr:.3g}); "
          f"{unequal} of {total} parameters not bit-equal")
    if not d <= 0.01 * sum_lr:
        raise AssertionError(f"kernel and twin training differ by {d}")


def time_training(base, dev, batches, tag: str, trials: int = 5):
    """Phase 6e: ms per train step (bf16, batch 64) of (a) prefix-only and
    (b) full finetune with the fused-AdamW kernel, and of (b) with the
    plain optax-order AdamW: median of trials after warm-up, and the peak
    device memory of each.  Returns the last run's step function (fused
    full finetune), for the profile, and the medians."""
    from clipcap_tpu_torch.train.state import create_train_state, make_optimizer
    from clipcap_tpu_torch.train.step import train_step

    out = {}
    for label, full, fused in (("a prefix-only", False, True),
                               ("b full finetune, plain AdamW", True, False),
                               ("b full finetune", True, True)):
        model = copy.deepcopy(base).to(dev)
        tx = make_optimizer(2e-5, 2, 1000, train_language_model=full, fused=fused)
        st = create_train_state(model, tx)

        def step(batch, st=st, tx=tx, full=full):
            return train_step(st, *batch, tx=tx, dtype=torch.bfloat16, remat=full)

        torch.cuda.reset_peak_memory_stats()
        for batch in batches[:2]:
            step(batch)
        sync(dev)
        per_trial = []
        for _ in range(trials):
            t0 = time.perf_counter()
            for batch in batches:
                step(batch)
            sync(dev)
            per_trial.append((time.perf_counter() - t0) / len(batches) * 1e3)
        med = statistics.median(per_trial)
        print(f"time [{tag}] train ({label}) GPT-2 b{TRAIN_BATCH} bf16: ms/step per trial "
              f"{[round(x, 2) for x in per_trial]}; median {med:.2f} ms, "
              f"{TRAIN_BATCH * 1e3 / med:.1f} samples/s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        out[label] = med
    return step, out


def run_training(dev, workdir: Path, tag: str):
    """Phase 6: training at full width.  Returns the fused-AdamW row of the
    kernels JSON."""
    from clipcap_tpu_torch.models.clipcap import init_clipcap
    from clipcap_tpu_torch.train.dataloader import get_dataloader

    root = workdir / "dataset"
    embeds = write_train_dataset(root)
    embedding = torch.from_numpy(embeds[0]).to(dev)
    launches = 0
    for label, extra in (("a prefix-only", []), ("b full finetune", ["--train-language-model",
                                                                     "true"])):
        launches += train_cli(dev, root, workdir / label.split()[0], label, extra, embedding)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        base = init_clipcap(train_config())
    err, times = check_adamw(base, dev, tag)
    loader, _ = get_dataloader(str(root), language_model="gpt2", batch_size=TRAIN_BATCH)
    batches = [(torch.from_numpy(t).to(dev), torch.from_numpy(e).to(dev)) for t, e in loader]
    three_steps(base, dev, batches)
    step, medians = time_training(base, dev, batches[:4], tag)
    profile(step, batches[0], medians["b full finetune"], "train step, full finetune b64 bf16",
            tag)
    return {"name": "fused_adamw", "route": "cuda",
            "source": "clipcap_tpu_torch/csrc/fused_adamw.cu",
            "replaces": "clipcap_tpu/ops/fused_adamw.py:125",
            "launches": launches, "max_abs_err": err, **times}


def seeded_xl(dev):
    """Phase 7a: GPT-2 XL (1600 wide, 48 layers, 25 heads) + the 8-layer
    transformer mapper for 768-d embeddings, fp32 on the card, seeded there
    (normal(0, 0.02) matrices, zero biases, unit norm scales): numpy draws
    of 1.8B parameters would take a minute on the host."""
    from clipcap_tpu_torch.config import Config, EncoderConfig
    from clipcap_tpu_torch.models.clipcap import ClipCapModel, build_mapper_config
    from clipcap_tpu_torch.models.gpt2 import GPT2, get_gpt2_config
    from clipcap_tpu_torch.models.mapper import TransformerMapper

    config = Config(language_model="gpt2-xl", prefix_length=P, projection_length=P,
                    transformer_layers=8, transformer_attention_heads=8,
                    encoder_config=EncoderConfig(encoder_model_variant="ViT-L/14",
                                                 encoder_embedding_size=768))
    lm_config = get_gpt2_config("gpt2-xl")
    model = ClipCapModel(config, GPT2(lm_config),
                         TransformerMapper(build_mapper_config(config, lm_config.n_embd))).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=g)
    return model


def agreement(a, b) -> str:
    """How far two beam results' tokens agree."""
    same = (a.tokens == b.tokens).all(dim=-1)
    if bool(same.all()):
        return "tokens equal"
    diff = (a.tokens != b.tokens).flatten(0, 1).float().argmax(dim=-1)
    return (f"{int(same.sum())} of {same.numel()} beams equal, first difference at step "
            f"{int(diff[~same.flatten()].min())}")


def xl_gates(model, dev):
    """Phase 7b: fp32 GPT-2 XL beam 5, R = 4, 67 new tokens.

    bf16/fp32 cache: the arithmetic is continuous, so the tokens through
    the kernels equal those through the twins (the decode attention patched
    to them in this script alone) at C = 8, and C = 8 equals C = 0.  int8
    cache: rounding to int8 is not continuous; a difference in fp32
    summation order (~1e-7) flips the odd quantised value, which moves the
    hidden state by ~1e-4, and two runs drift apart.  So the int8 runs
    (C = 0 and C = 8) are checked in lockstep: every decode attention call
    launches the kernel and its twin on the same inputs, the inputs of the
    main path itself, and the two must agree within 1e-4.  Their token
    agreement with full twin runs, C = 8 against C = 0, and a control (the
    same run from a prefix moved by 1e-6 relative) are printed."""
    from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
    from clipcap_tpu_torch.models import gpt2
    from clipcap_tpu_torch.ops.flash_decode import (flash_decode, flash_decode_ref,
                                                    flash_decode_two_phase,
                                                    flash_decode_two_phase_ref)

    g = torch.Generator(device=dev).manual_seed(4)
    prefix = model.transformer_mapper(torch.randn(4, 768, generator=g, device=dev))
    moved = prefix * (1 + 1e-6)

    def lockstep(kernel, twin, diffs):
        def call(*args, **kw):
            got = kernel(*args, **kw)
            diffs.append((got - twin(*args, **kw)).abs().max())
            return got
        return call

    def run(int8: bool, C: int, mode: str = "kernel", x=prefix):
        bp = BeamParams(beam_size=K, max_new_tokens=N_NEW, stop_token=50256, int8_kv=int8,
                        consolidate_every=C)
        n0 = flash_decode.launches + flash_decode_two_phase.launches
        diffs = []
        with contextlib.ExitStack() as patches:
            for name, kernel, twin in (("flash_decode", flash_decode, flash_decode_ref),
                                       ("flash_decode_two_phase", flash_decode_two_phase,
                                        flash_decode_two_phase_ref)):
                if mode != "kernel":
                    patches.enter_context(mock.patch.object(
                        gpt2, name, twin if mode == "twin" else lockstep(kernel, twin, diffs)))
            res = beam_search_batched(model.language_model, x, bp, dtype=torch.float32)
        n = flash_decode.launches + flash_decode_two_phase.launches - n0
        if (n == 0) != (mode == "twin"):
            raise AssertionError(f"xl int8={int8} C={C} {mode}: {n} kernel launches")
        if mode == "lockstep":
            d = torch.stack(diffs).max().item()
            print(f"xl: fp32 R=4 int8={int8} C={C} lockstep: {len(diffs)} decode attention "
                  f"calls, kernel vs twin max|d| {d:.3g} (tol 1e-4)")
            if not d <= 1e-4:
                raise AssertionError(f"xl int8={int8} C={C}: kernel and twin differ by {d}")
        return res

    bf_c0, bf_c8 = run(False, 0), run(False, 8)
    for label, a, b in (("C=8 kernels vs twins", bf_c8, run(False, 8, "twin")),
                        ("C=8 vs C=0", bf_c8, bf_c0)):
        same = torch.equal(a.tokens, b.tokens)
        print(f"xl: fp32 R=4 bf16-form cache {label}: {agreement(a, b)}; max|d score| "
              f"{(a.scores - b.scores).abs().max().item():.3g}")
        if not same:
            raise AssertionError(f"xl fp32 cache {label}: tokens differ")
    i8_c0, i8_c8 = run(True, 0, "lockstep"), run(True, 8, "lockstep")
    for label, a, b in (("C=0 kernels vs twins", i8_c0, run(True, 0, "twin")),
                        ("C=8 kernels vs twins", i8_c8, run(True, 8, "twin")),
                        ("C=8 vs C=0", i8_c8, i8_c0),
                        ("C=0 vs itself from a prefix moved by 1e-6", i8_c0,
                         run(True, 0, x=moved))):
        print(f"xl: fp32 R=4 int8 cache {label} (information): {agreement(a, b)}")
    print(f"xl: fp32 R=4 bf16-form cache C=0 vs itself from a prefix moved by 1e-6 "
          f"(information): {agreement(bf_c0, run(False, 0, x=moved))}")


def int8_cli(slice_dir: Path, dev):
    """Phase 7c: ``python -m clipcap_tpu_torch.inference --int8-kv-cache``'s
    function on the GPT-2 124M checkpoint of phase 3."""
    from argparse import ArgumentParser

    from clipcap_tpu_torch.inference.args import add_inference_args
    from clipcap_tpu_torch.inference.demo import inference_demo

    args = add_inference_args(ArgumentParser()).parse_args(
        ["--model-path", str(slice_dir / "model.npz"), "--config-path",
         str(slice_dir / "config.yaml"), "--sample-path", str(slice_dir / "image.png"),
         "--device", str(dev), "--int8-kv-cache", "--number-to-generate", "5"])
    log = io.StringIO()
    with warnings.catch_warnings(), contextlib.redirect_stdout(log):
        warnings.simplefilter("ignore")               # seeded CLIP: no checkpoint offline
        rc = inference_demo(args)
    lines = log.getvalue().splitlines()
    if rc != 0 or sum(line.startswith("sim ") for line in lines) != 5 or "best" not in lines[-1]:
        raise AssertionError(f"int8 CLI: exit {rc}, output {lines}")
    print(f"xl: CLI --int8-kv-cache on the GPT-2 124M checkpoint: 5 captions; {lines[-1]!r}")


def run_xl(dev, slice_dir: Path, tag: str):
    """Phase 7: GPT-2 XL beam 5 with an int8 KV cache and converged-prefix
    consolidation.  Returns the rows of the two new kernels."""
    from clipcap_tpu_torch import generate_beam
    from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
    from clipcap_tpu_torch.ops.flash_decode import flash_decode, flash_decode_two_phase
    from clipcap_tpu_torch.utils.tokenizer import get_tokenizer

    t_phase = time.perf_counter()
    model = seeded_xl(dev)
    sync(dev)
    print(f"xl: seeded GPT-2 XL + 8-layer mapper on the card in "
          f"{time.perf_counter() - t_phase:.1f} s")
    xl_gates(model, dev)
    model.to(torch.bfloat16)
    lm, bf = model.language_model, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(5)
    prefix = model.transformer_mapper(torch.randn(XL_BATCH, 768, generator=g, device=dev),
                                      dtype=bf)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")               # byte-level tokenizer offline
        tokenizer = get_tokenizer("gpt2")

    # The main path: every count set to 0 just before, read just after.
    flash_decode.launches = flash_decode.int8_launches = flash_decode_two_phase.launches = 0
    t0 = time.perf_counter()
    int8_cli(slice_dir, dev)
    beams = generate_beam(model, tokenizer, prefix[:1], number_to_generate=5, beam_size=K,
                          int8_kv=True, dtype=bf)
    results = [beam_search_batched(lm, prefix, BeamParams(beam_size=K, max_new_tokens=N_NEW,
                                                          stop_token=tokenizer.eos_token_id,
                                                          int8_kv=int8, consolidate_every=8),
                                   dtype=bf) for int8 in (False, True)]
    sync(dev)
    launches = {"flash_decode_int8": flash_decode.int8_launches,
                "flash_decode_two_phase": flash_decode_two_phase.launches}
    print(f"xl: CLI + generate_beam(int8_kv=True) + beam_search_batched b{XL_BATCH} C=8 "
          f"(bf16 and int8 caches) in {time.perf_counter() - t0:.1f} s; launches {launches}")
    if len(beams) != 5 or not all(isinstance(b, str) for b in beams):
        raise AssertionError(f"xl generate_beam returned {beams}")
    for res in results:
        if res.tokens.shape != (XL_BATCH, K, N_NEW) or not torch.isfinite(res.scores).all():
            raise AssertionError(f"xl beam search: tokens {tuple(res.tokens.shape)}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the GPT-2 XL phase never launched {name}")
    print(f"xl: best int8 beam {beams[0]!r}")

    # Timings (information): b96 beam 5, bf16, two distinct batches a trial.
    inputs = [prefix] + [model.transformer_mapper(
        torch.randn(XL_BATCH, 768, generator=g, device=dev), dtype=bf)]
    medians = {}
    for int8, C in ((False, 0), (True, 0), (False, 8), (True, 8)):
        bp = BeamParams(beam_size=K, max_new_tokens=N_NEW, stop_token=50256, int8_kv=int8,
                        consolidate_every=C)

        def work(x, bp=bp):
            return beam_search_batched(lm, x, bp, dtype=bf)

        torch.cuda.reset_peak_memory_stats()
        cps = rate(work, inputs, XL_BATCH, trials=2)
        medians[int8, C] = statistics.median(cps)
        print(f"time [{tag}] beam-5 GPT-2 XL b{XL_BATCH} bf16 int8_kv={int8} "
              f"consolidate_every={C}: captions/s per trial {cps}; median "
              f"{medians[int8, C]:.2f}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if (int8, C) == (True, 0):
            profile(work, inputs[0], XL_BATCH * 1e3 / medians[int8, C],
                    f"beam-5 GPT-2 XL b{XL_BATCH} int8 C=0", tag)
    times = time_kv_kernels(dev, tag)
    print(f"xl: phase took {time.perf_counter() - t_phase:.1f} s")
    return {name: {"launches": launches[name], **times[name]} for name in launches}


def run_phases(dev, workdir: Path, name_limit: str, host_line: str, errors: dict) -> list:
    """Phases 3-7 in ``workdir``; returns the kernels' rows."""
    slice_dir, train_dir = workdir / "slice", workdir / "train"
    slice_dir.mkdir()
    train_dir.mkdir()
    model, encoder, launches = run_slice(dev, slice_dir)
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
    del beam, beam_inputs, vit, vit_inputs, model, encoder
    adamw_row = run_training(dev, train_dir, name_limit)
    torch.cuda.empty_cache()
    xl_rows = run_xl(dev, slice_dir, name_limit)

    def row(name, source, replaces, **numbers):
        return {"name": name, "route": "cuda", "source": f"clipcap_tpu_torch/csrc/{source}",
                "replaces": replaces, **numbers}

    return [
        row("flash_decode", "flash_decode.cu", "clipcap_tpu/ops/flash_decode.py:407",
            launches=launches["flash_decode"], max_abs_err=errors["flash_decode"],
            **times["flash_decode"]),
        row("sdpa_packed", "sdpa_packed.cu", "clipcap_tpu/ops/attention.py:244",
            launches=launches["sdpa_packed"], max_abs_err=errors["sdpa_packed"],
            **times["sdpa_packed"]),
        adamw_row,
        row("flash_decode_int8", "flash_decode.cu", "clipcap_tpu/ops/flash_decode.py:407",
            max_abs_err=errors["flash_decode_int8"], **xl_rows["flash_decode_int8"]),
        row("flash_decode_two_phase", "flash_decode.cu", "clipcap_tpu/ops/flash_decode.py:784",
            max_abs_err=errors["flash_decode_two_phase"], **xl_rows["flash_decode_two_phase"]),
    ]


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
    workdir = Path(tempfile.mkdtemp(dir=build_root))
    try:
        kernels = run_phases(dev, workdir, name_limit, host_line, errors)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if "jax" in sys.modules or any(n.split(".")[0] == "clipcap_tpu" for n in sys.modules):
        raise AssertionError("the port loaded jax or the JAX package")

    print(json.dumps({"kernels": kernels}))
    print(name_limit)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
