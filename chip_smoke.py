"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the last line):

1. environment: the card, torch and CUDA versions; build the CUDA kernels
   from ``clipcap_tpu_torch/csrc`` and time the build;
2. each kernel against its plain PyTorch twin at the slice's shapes, bf16
   and fp32 (fp32 within 1e-4 abs, bf16 within 2e-2 abs); the int8 and
   two-phase decode kernels at GPT-2 XL beam-5 shapes (R = 96, H = 25,
   K = 5): the int8 folded cache, per-row bounds, the carry, and bf16/fp32
   or int8 shared + live regions with a random per-sample converged length;
   ``sdpa_packed`` also at ViT-L/14's row length (N = 257, D = 1024, 16
   heads: the preprocess path's shape); ``fused_sdpa`` (the head-major
   entry of the same attention core) at [B, H, N] = (8, 12, 50), (5, 8, 77,
   causal), (32, 16, 257) and (4, 16, 512); the patch-embed kernel at ViT-L/14
   b256 and ViT-B/32 b512 shapes, odd batches (M ragged against its
   128-patch tile), widths 64 and 320 (ragged against its 256-column
   tile), a batch that takes two rounds of its persistent grid, ViT-B/16,
   both pixel paths (copy engine and bytes) at P = 14, 16 and 32 (batches
   that do not start 16-byte aligned) and at an odd P = 7, ViT-L/14@336px
   (a one-stage pixel ring; b256 and a ragged b3, on both paths), and 255 in
   every pixel, with and without bias (within one bf16 ulp of the largest
   output, 2^-7·max|ref|); the
   manual-pipeline decode kernel (ring depth S = 2, 3 and 4) on the strided
   and the tile-major cache, and the auto kernel on the tile-major cache,
   at beam R = 128 (H = 12, K = 5, U = 384, u = 64), sampling R = 160
   (K = 1, U = 80, u = 80: the kernel's 64-slot tiles straddle the
   layout's) and GPT-2 XL R = 96 (H = 25), at the decode loops' masks and
   at the u_valid boundaries of both kinds of tile; and the auto and
   two-phase kernels at bounds that cut the bf16 kernels' 16-slot mma
   fragments and 32-slot warp chunks (1, 15, 16, 17, 31, 33, 64, 65, 129,
   215; host and per-row; the carry split at 100), K = 1, 5 and 8 at
   H = 25, bf16/fp32 and int8 caches, the tile-major cache of 80-slot
   tiles, and the four int8/bf16 region mixes; the manual kernel at the
   same bounds (S = 2, 3 and 4, both layouts), and over a cache and a mask
   that hold NaN outside each row's bounds (finite, and equal to the twin
   on the clean ones); the attention kernels at N = 1, 63, 64, 65, 257 and
   577 (577 packed only) with and without causal, on 1,024 heads (the
   persistent grid wraps), at N = 900 (K and V through the ring), at
   scales -0.2, 0 and 0.5, and on operands at the start of buffers filled
   with NaN past their end (finite, and equal to the twin);
3. the captioning slice at full width (CLIP ViT-B/32, the 8-layer
   transformer mapper, GPT-2 124M) with seeded weights, through the public
   entry points: save an ``.npz`` + YAML, ``load(..., device="cuda")``,
   ``get_encoder_from_model``, the mapper, ``generate_beam`` (beam 5) and
   ``generate_nucleus_sampling`` + the CLIP rerank.  Both kernels' launch
   counts must rise over this run, the encoder's tower call must launch
   ``quick_gelu`` once a block (12), and fp32 beam-5 tokens through the
   kernels must equal those through the twins (a reference run with the
   decode attention patched to the twin, here only); then the attention
   façade ``sdpa(q, k, v)`` once at ViT-L/14 width (b256, N = 257, 16
   heads, bf16) with ``fused_sdpa.launches`` set to 0 just before: it must
   launch ``fused_sdpa`` and agree with the twin within 2e-2;
4. timings (information, not gates): beam-5 captions/s (GPT-2 + mapper in
   bf16, batch 128, 67 new tokens), ViT-B/32 embeds/s (batch 512, uint8),
   each kernel against its twin (``sdpa_packed`` at ViT-B/32 b512, the text
   tower b5, ViT-L/14 b256 and ViT-L/14@336px b256; ``fused_sdpa`` at
   ViT-B/32 b512 and ViT-L/14 b256, head-major; the attention rows on both
   clocks, with the L2 flushed before each call, and in TFLOP/s);
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
   breakdown of an (int8, C=0) batch cut to 8 new tokens, each new kernel
   against its twin
   and its bound.  Then the decode forms: fp32 R = 4 tokens at C = 0 must
   be equal through the strided cache and the auto kernel, the tile-major
   cache (``tm``), the manual-pipeline kernel (``man``) and both
   (``mantm``); at b96 bf16 each form runs with its counts set to 0 just
   before (the manual forms must launch the manual kernel, the others
   must not), with captions/s and peak memory as information; and the
   manual kernel (S = 2, 3, 4) beside the auto kernel, on both layouts, the
   twin and SDPA on the strided view, at R = 128 and R = 96, with the
   bound, its design and its time over the auto kernel's;
8. the preprocess stage at CLIP ViT-L/14 (seeded weights) through
   ``clipcap_tpu_torch.preprocess``'s entry point, batch 256, on 1,024
   seeded noise JPEGs of two sizes with ``.txt`` captions in two output
   partitions, and a webdataset shard of 256 more with ``json/caption``
   captions.  Gates: exit 0, fp32 ``[n, 768]`` finite embeddings, captions
   equal to the sources in key order, ``encoder_embedding_size: 768``,
   ``patch_embed`` and ``sdpa_packed`` (23 per batch) launched,
   ``quick_gelu`` launched once a block of every batch (24 × 5), and the
   first 256 images of partition 0 through the same encoder with the patch
   embedding patched to its twin (here only) within cosine 0.999 of the
   written rows.  Information: images/s of each run through the runner
   (read/decode + encode + write, the per-image cost) and end to end with
   the encoder build, the runner's split, ViT-L/14 b256 embeds/s with the kernel and
   with the twin, a ``torch.profiler`` breakdown of one batch, and the
   patch kernel against its twin, ``F.conv2d`` and the eager route at
   ViT-L/14, ViT-B/32 and ViT-L/14@336px shapes on both clocks, and with
   the L2 flushed before each call;
9. the eval stage through ``clipcap_tpu_torch.eval.base.run_eval(argv)``
   on the phase-3 checkpoint: 64 seeded JPEGs, a seeded reference CSV of
   five captions each, batches of 32 x 5 candidates, bf16, with
   ``CLIPCAP_CACHE_TILE_MAJOR=1`` and ``CLIPCAP_FLASH_MANUAL=1`` and every
   count set to 0 just before.  Gates: exit 0, one prediction per image,
   every metric present and finite, the manual kernel and
   ``sdpa_packed`` launched; then fp32 ``--top-k 1`` predictions equal
   with the two switches on and off.  Information: generation samples/s
   and scoring seconds, a ``torch.profiler`` breakdown of one generation
   batch's decode, and the manual kernel at that decode's shape (R = 160,
   H = 12, K = 1, one 80-slot tile) beside the auto kernel, the twin and
   SDPA, with the bound;
10. the last CLI stages and int8 serving, each path with its counts set to
   0 just before and read just after.  (a) After phase 6:
   ``clipcap_tpu_torch.finetune.start_finetuning`` (argv without
   ``--train-language-model``) on phase 6's dataset, GPT-2 124M + mapper,
   bf16, batch 64, 11 steps; gates as phase 6b's, and GPT-2's weights
   moved; then ``utils.export_checkpoint.export_params`` on its final
   checkpoint, and the params-only file loads on the card and captions.
   (c) After phase 8: phase 8's seeded ViT-L/14 quantised w8a8 from its fp32
   weights; the fp32 float tower within 1e-3 of the port's CPU forward of
   the same image, and the fp32 w8a8 forward at B = 1, 17 and 64 (the
   class-token block's ``_int_mm`` on padded rows below 17) in lockstep
   with the CPU: every ``int8_linear`` call also run on the CPU on the same
   inputs, within 1e-5 (the whole w8a8 forward against the CPU's is
   printed: int8 rounding carries summation-order differences to ~1e-2, as
   phase 7 found for the int8 cache); ``CLIPEncoder(int8=True).similarity``
   at B = 1 equal to ``clip_similarity(int8_acts=True)`` within 1e-4; the
   preprocess entry point with ``--int8-encoder true`` on one 256-image
   partition: exit 0, finite [256, 768] rows, ``patch_embed`` and
   ``sdpa_packed`` launched.  Information: ViT-L/14 w8a8 b64 embeds/s
   beside bf16 b64 and phase 8's bf16 b256, the four projections
   (``int8_linear``, ``_int_mm``, ``quantize_rows``) against the bf16
   ``linear``, and the cosine of w8a8 against the float tower.  (b) After
   phase 9: phase 7's seeded GPT-2 XL, its LM quantised from the fp32
   weights; fp32 beam 5 at R = 4, 67 new tokens, tokens through the kernels
   equal to those through the twins, ``flash_decode`` launched; one
   prefill's logits within 1e-3 (max|d| over max|ref|) of the same int8
   model's on the CPU; ``--int8-weights`` through the inference CLI's
   function and eval's generation on the phase-3 checkpoint, both
   launching ``flash_decode``.  Information: captions/s and peak device
   memory at b96 bf16, C = 0, bf16 and int8 caches, beside phase 7's bf16
   weights, a ``torch.profiler`` breakdown of one int8-cache batch cut to
   8 new tokens, as phase 7's, and the time of the eager int8 → bf16
   widening of one forward's block weights;
11. audio captioning at full width (CLAP: HTSAT-tiny with a RoBERTa-base
   text tower and the 768 → 512 → 512 projections, seeded, saved as one
   laion_clap-format ``.pt`` that ``load_clap`` reads through
   ``$CLIPCAP_CLAP_CHECKPOINT``), each path with its counts set to 0 just
   before and read just after: (a) 256 seeded WAV clips (half 10 s at
   44.1 kHz stereo, half 20 s at 48 kHz mono) through
   ``start_preprocess(argv)`` with ``--encoder-model-name clap``, batch
   64; gates: exit 0, finite fp32 [256, 512] rows, captions equal to the
   sources, ``encoder_embedding_size: 512``, and 8 clips' fp32 embeddings
   on the card within 1e-3 (‖d‖/‖ref‖) of the port's CPU forward, in
   plain mode and in fusion mode (a seeded fusion checkpoint with
   ``mel_conv2d`` and AFF, on 8 clips of 25 s); (b) training on that
   dataset (GPT-2 124M + 8-layer mapper, prefix-only, bf16, batch 64, the
   fused-AdamW kernel, one epoch: ``fused_adamw`` launched each step, finite
   losses); (c) ``load`` + ``get_encoder_from_model`` (the CLAP encoder) +
   beam 5 on one clip, fp32 beam-5 tokens through the kernels equal to those
   through the twin; (d) nucleus sampling and the CLAP rerank, whose
   similarities on the card are within 1e-4 of the CPU's; (e) the inference
   CLI's function on one ``.wav``; (f) the eval function on 32 clips with a
   seeded five-reference CSV, batch 32 x 5 (exit 0, finite metrics);
   ``flash_decode`` launched in each of (c)-(f).  Information: HTSAT-tiny
   b64 fp32 embeds/s, the preprocess runner's clips/s and split, a
   ``torch.profiler`` breakdown of one encoder batch, and the rerank's text
   tower at 5 and 160 captions;
12. the CLIP ResNet towers: a seeded RN50 in OpenAI's layout through
   ``$CLIPCAP_CLIP_CHECKPOINT``; ``start_preprocess(argv)`` with
   ``--encoder-model-variant RN50``, batch 256, on phase 8's first 256
   images (exit 0, finite [256, 1024] rows, ``patch_embed`` not launched);
   8 images' fp32 RN50 embeddings on the card within 1e-3 of the CPU's;
   ``CLIPEncoder.similarity`` launching ``sdpa_packed`` (the text tower);
   a 20-token beam-5 caption from an RN50-conditioned checkpoint launching
   ``flash_decode``; RN50x64 at 448 px, one seeded bf16 batch of 32, finite
   [32, 1024].  Information: RN50 b256 and RN50x64 b32 bf16 embeds/s and a
   ``torch.profiler`` breakdown of one RN50 batch;
13. DeepSeek-V2-Lite's routed experts (``run_dsv2(dev, tag)``, ~2 min): the
   grouped expert kernels against their twin at the caption cell's decode shape
   (640 tokens × top 6 of 64 experts, D 2048, F 1408) under random routing,
   skewed routing (several row tiles an expert) and an expert no token
   chose; graphed beam search on a small DeepSeek-V2 against the same
   segments run eagerly (tokens, lengths, scores bit-identical);
   DeepSeek-V2-Lite at its published widths, seeded bf16 on the card,
   under the caption cell's beam search (b128, beam 5, 67 new tokens; its
   second search): the grouped kernels launch exactly 2 × 26 MoE layers ×
   (1 prefill + decode steps) times (the row's ``launches``) and no expert
   runs through ``torch._grouped_mm``.  Information: the kernels' time
   beside their bound, the twin, a per-expert ``torch.matmul`` loop and
   ``torch._grouped_mm`` (a yardstick the port never calls).
14. Kimi-Linear's KDA decode step (``run_kimi(dev, tag)``): the kernel
   against its twin at the caption cell's shape (96 samples × 5 beams, 32
   heads of 128, bf16; a first step from zero state, then parents drawn
   at random within each sample, two parents a sample, and all five beams
   on one parent: outputs within 2e-2 of their scale, states within 1e-4,
   windows bit for bit); graphed beam search on a small Kimi-Linear that
   holds a share of its experts against the same segments run eagerly
   (bit-identical); Kimi-Linear-48B-A3B at its published widths with 32 of
   256 experts held, seeded bf16 on the card, under the caption cell's
   beam search (b96, beam 5, 67 new tokens; its second search): the KDA
   kernel launches exactly 20 KDA layers × (10 prefix positions + decode
   steps) times.  Information: the kernel's time beside its bound (each
   distinct parent's state read once, every row's written) and the twin.
15. Granite-4.0-H's Mamba decode step (``run_granite(dev, tag)``): the
   kernel against its twin at the caption cell's shape (64 samples × 5
   beams, 128 heads of 64, a state of 128, bf16; a first step from zero
   state, then parents drawn at random within each sample, two parents a
   sample, and all five beams on one parent: outputs and states within
   2e-2 of their scale, windows bit for bit); graphed beam search on a
   small Granite-4.0-H that holds a share of its experts against the same
   segments run eagerly (bit-identical); Granite-4.0-H-Small at its
   published widths with 9 of 72 experts held, seeded bf16 on the card,
   under the caption cell's beam search (b64, beam 5, 67 new tokens; its
   second search): the Mamba kernel launches exactly 36 Mamba layers × (10
   prefix positions + decode steps) times.  Information: the kernel's time
   beside its bound (each distinct parent's state and window read once,
   every row's written) and the twin.
16. CLIP's QuickGELU (``run_quick_gelu(dev, tag)``, ~1 min): at ViT-L/14
   b256's ``[256, 257, 4096]`` and ViT-B/32 b128's ``[128, 50, 3072]``
   bf16, the forward and backward kernels within one bf16 ulp of the
   float32 formula, one launch a forward call and one a backward call.
   Information: both kernels at those shapes on both clocks beside their
   bound (x, and dy, read and the output written once), the plain twin
   (the eager scale, sigmoid and product: the path before the kernel) and
   its backward under autograd; the small shape also with the L2 flushed.
   The tower counts are held on the main path, in phases 3 and 8.

Every kernel's row carries its bound (bytes over 3.35 TB/s or operations
over the data sheet's peak, whichever is larger) and the time of one
PyTorch call that computes the same function, where there is one.  Two
clocks: ``ms`` is CUDA events around 20 back-to-back calls (``cuda_ms``:
where a kernel is shorter than its wrapper's host time it reads the host),
``device_ms`` the mean kernel duration per call that ``torch.profiler``
records (``device_ms``); the decode rows (phase 4a row 1, phase 7d's int8
and two-phase rows, phase 7f's tile-major and manual rows, phase 9's
eval-shape manual row) and the attention rows (phase 4a) give both, for
the kernel, the twin and the library call.

Output: one line per finding, then the kernels as one JSON object, then the
card's ``name, power.limit``, then ``{"ok": true, "device": {...}}``.
"""
import os

os.environ.setdefault("HF_HUB_OFFLINE", "1")          # no hub retries offline
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import contextlib  # noqa: E402
import copy  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
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


def device_us(e) -> float:
    """Device time of a profiler event (the attribute's name moved across
    torch versions)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def device_ms(fn, iters: int = 20, only: str | None = None):
    """Mean device time of one ``fn()`` call from the CUPTI durations that
    ``torch.profiler`` records over ``iters`` calls after warm-up: each
    kernel's mean over the instances the trace holds, times its launches
    per call (its count over ``iters``, at least 1), summed.  A trace can
    drop events, and a sum over ``iters`` would then read low (it read
    0.0188 ms for a 0.037 ms kernel).  Unlike ``cuda_ms`` it leaves out the
    host's gaps between launches.  ``only``: count only the kernels whose
    name holds it.  A trace that comes back without device events is taken
    again, up to three times; None if none has any."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        call_us = sum(device_us(e) / e.count * max(1, round(e.count / iters))
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA and e.count
                      and (only is None or only in e.key))
        del prof
        if call_us > 0:
            return call_us / 1e3
    return None


def timed(fn, prefix: str = "") -> dict:
    """``fn``'s time on both clocks: ``<prefix>ms`` (CUDA events around
    back-to-back calls) and ``<prefix>device_ms`` (kernel durations)."""
    return {f"{prefix}ms": cuda_ms(fn), f"{prefix}device_ms": device_ms(fn)}


def check_kernels(dev):
    """Phase 2: every kernel against its twin; returns max |Δ| per kernel."""
    from clipcap_tpu_torch.models.gpt2 import beam_mask, causal_bias
    from clipcap_tpu_torch.ops.attention import (fused_sdpa, fused_sdpa_ref, sdpa_packed,
                                                 sdpa_packed_ref)
    from clipcap_tpu_torch.ops.flash_decode import flash_decode, flash_decode_ref

    g = torch.Generator(device=dev).manual_seed(0)
    err = {"flash_decode": 0.0, "sdpa_packed": 0.0, "flash_decode_int8": 0.0,
           "flash_decode_two_phase": 0.0, "fused_sdpa": 0.0, "flash_decode_manual": 0.0,
           "flash_decode_tile_major": 0.0}

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
                                          (32, 257, 1024, 16, False, "ViT-L/14"),
                                          (2, 577, 1024, 16, False, "N=577")):
            qkv = torch.randn(B, N, 3 * D, generator=g, device=dev).to(dtype)
            compare("sdpa_packed", f"{label} B={B} N={N} D={D} causal={causal}", dtype,
                    sdpa_packed(qkv, H, causal=causal), sdpa_packed_ref(qkv, H, causal=causal))
        for B, H, N, causal in FUSED_SHAPES:
            q, k, v = (torch.randn(B, H, N, 64, generator=g, device=dev).to(dtype)
                       for _ in range(3))
            compare("fused_sdpa", f"B={B} H={H} N={N} causal={causal}", dtype,
                    fused_sdpa(q, k, v, causal=causal), fused_sdpa_ref(q, k, v, causal=causal))
        check_attention_edges(dev, g, dtype, compare)
        check_kv_kernels(dev, g, dtype, compare)
        check_manual_kernels(dev, g, dtype, compare)
        check_fragment_edges(dev, g, dtype, compare)
    err["patch_embed"] = check_patch_embed(dev, g)
    torch.cuda.synchronize()
    return err


def tile_major(kv, u: int):
    """A strided cache [R, H, U, 128] as the tile-major [R, U // u, H, u, 128]."""
    R, H, U, D2 = kv.shape
    return kv.reshape(R, H, U // u, u, D2).permute(0, 2, 1, 3, 4).contiguous()


# The manual-pipeline kernel's phase-2 shapes: (label, R, H, K, U, u); the
# u-tile is the JAX package's (``_pick_u_tile``): 64 for the beam caches, one
# 80-slot tile for sampling, where the kernel's 64-slot tiles straddle it.
MANUAL_SHAPES = (("beam", 128, 12, K, 384, 64), ("sample", 160, 12, 1, 80, 80),
                 ("XL beam", XL_BATCH, XL_HEADS, K, 384, 64))


def check_manual_kernels(dev, g, dtype, compare):
    """Phase 2, the manual-pipeline kernel (ring depth S = 2, 3 and 4) and the
    auto kernel's tile-major form against the twin, on the strided and the
    tile-major cache, at the decode loops' masks and at the u_valid
    boundaries of the kernel's 64-slot tiles and of the layout's tiles."""
    from clipcap_tpu_torch.models.gpt2 import beam_mask, causal_bias
    from clipcap_tpu_torch.ops.flash_decode import _pick_u_tile, flash_decode, flash_decode_ref

    for label, R, H, Kq, U, u in MANUAL_SHAPES:
        assert _pick_u_tile(U) == u
        q = torch.randn(R, H, Kq, 64, generator=g, device=dev).to(dtype)
        kv = torch.randn(R, H, U, 128, generator=g, device=dev).to(dtype)
        layouts = (("strided", kv), ("tile-major", tile_major(kv, u)))
        cases = []
        if Kq == 1:
            for pos in (P, 40, P + N_NEW - 1):
                cases.append((pos + 1, causal_bias(1, U, pos, device=dev)[:, 0]))
        else:
            anc = torch.randint(0, Kq, (R * Kq, N_NEW), generator=g, device=dev)
            for step in (0, 1, 30, N_NEW - 1):
                cases.append((P + (step + 1) * Kq,
                              beam_mask(anc, Kq, U, offset=P + step, cache_base=P)))
        rand = torch.where(torch.rand(R, Kq, U, generator=g, device=dev) < 0.5, 0.0, -1e9)
        rand[..., 0] = 0.0
        cases += [(b, rand) for b in (1, 63, 64, 65, u - 1, u + 1, U) if 0 < b <= U]
        for u_valid, mask in cases:
            for form, kvx in layouts:
                want = flash_decode_ref(q, kvx, mask, u_valid)
                shape = f"{label} R={R} H={H} K={Kq} U={U} u={u} {form} u_valid={u_valid}"
                for slots in MANUAL_SLOTS:
                    with mock.patch.dict(os.environ, {"CLIPCAP_FLASH_MANUAL_SLOTS": slots}):
                        got = flash_decode(q, kvx, mask, u_valid, manual=True)
                    compare("flash_decode_manual", f"{shape} S={slots}", dtype, got, want)
                if form == "tile-major":
                    compare("flash_decode_tile_major", shape, dtype,
                            flash_decode(q, kvx, mask, u_valid, manual=False), want)


# Slot bounds that end inside, at and just past the 16-slot mma fragments
# and the 32-slot warp chunks of the bf16 kernels.
EDGES = (1, 15, 16, 17, 31, 33, 64, 65, 129, 215)


def check_fragment_edges(dev, g, dtype, compare):
    """Phase 2, the auto, manual and two-phase kernels at slot bounds that
    cut an mma fragment or a warp's chunk: K = 1, 5 and 8 queries; bf16/fp32
    and int8 caches at GPT-2 XL's 25 heads, host bounds and per-row ``[R]``
    bounds, and the carry over [0, 100) resumed to the end; the manual
    kernel at S = 2, 3 and 4 on both layouts, also over NaN outside each
    row's bounds (``check_manual_edges``); the tile-major cache of 80-slot
    tiles (a fragment straddles slot 80), auto and manual; the four
    int8/bf16 region mixes of the two-phase kernel with per-row edges."""
    from clipcap_tpu_torch.ops.flash_decode import (flash_decode, flash_decode_ref,
                                                    flash_decode_two_phase,
                                                    flash_decode_two_phase_ref)

    R, H, U = 8, XL_HEADS, 256
    for Kq in (1, 5, 8):
        q = torch.randn(R, H, Kq, 64, generator=g, device=dev).to(dtype)
        mask = torch.where(torch.rand(R, Kq, U, generator=g, device=dev) < 0.5, 0.0, -1e9)
        mask[..., 0] = 0.0
        lo = torch.tensor([0, 1, 15, 16, 17, 31, 33, 100], dtype=torch.int32, device=dev)
        hi = torch.tensor([1, 16, 17, 33, 64, 65, 129, 215], dtype=torch.int32, device=dev)
        for int8 in (False, True):
            if int8:
                kv, scales = int8_cache(g, R, H, U, dev)
                name = "flash_decode_int8"
            else:
                kv, scales = torch.randn(R, H, U, 128, generator=g, device=dev).to(dtype), None
                name = "flash_decode"
            label = f"edges R={R} H={H} K={Kq}"
            for b in EDGES:
                compare(name, f"{label} u_valid={b}", dtype,
                        flash_decode(q, kv, mask, b, scales=scales),
                        flash_decode_ref(q, kv, mask, b, scales=scales))
            compare(name, f"{label} [lo, hi) u_lo=17 u_valid=215", dtype,
                    flash_decode(q, kv, mask, 215, scales=scales, u_lo=17),
                    flash_decode_ref(q, kv, mask, 215, scales=scales, u_lo=17))
            compare(name, f"{label} per-row [lo, hi)", dtype,
                    flash_decode(q, kv, mask, hi, scales=scales, u_lo=lo),
                    flash_decode_ref(q, kv, mask, hi, scales=scales, u_lo=lo))
            part = flash_decode(q, kv, mask, 100, scales=scales, return_carry=True)
            part_ref = flash_decode_ref(q, kv, mask, 100, scales=scales, return_carry=True)
            for what, a, b in zip(("m", "l"), part, part_ref):
                d = ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()
                if not d <= 1e-4:
                    raise AssertionError(f"{name} {label} carry {what}: max rel|d| {d}")
            compare(name, f"{label} carry [0, 100) resumed over [100, {U})", dtype,
                    flash_decode(q, kv, mask, U, scales=scales, u_lo=100, carry=part),
                    flash_decode_ref(q, kv, mask, U, scales=scales))
            if not int8:
                check_manual_edges(q, kv, mask, lo, hi, label, dtype, compare)
        kv = torch.randn(R, H, 240, 128, generator=g, device=dev).to(dtype)
        kv5 = tile_major(kv, 80)
        mask = mask[..., :240].contiguous()
        for b in (1, 15, 17, 79, 81, 95, 161, 240):
            want = flash_decode_ref(q, kv, mask, b)
            compare("flash_decode_tile_major", f"edges R={R} H={H} K={Kq} u=80 u_valid={b}",
                    dtype, flash_decode(q, kv5, mask, b, manual=False), want)
            for slots in MANUAL_SLOTS:
                with mock.patch.dict(os.environ, {"CLIPCAP_FLASH_MANUAL_SLOTS": slots}):
                    compare("flash_decode_manual",
                            f"edges R={R} H={H} K={Kq} u=80 u_valid={b} S={slots}", dtype,
                            flash_decode(q, kv5, mask, b, manual=True), want)
        for sh_int8, lv_int8 in ((False, False), (True, True), (True, False), (False, True)):
            sh, sh_s = region(g, R, H, 128, dtype, sh_int8, dev)
            lv, lv_s = region(g, R, H, 384 if lv_int8 else 336, dtype, lv_int8, dev)
            sh_mask = mask[..., :1].expand(R, Kq, 128).contiguous()
            lv_mask = torch.where(torch.rand(R, Kq, lv.shape[2], generator=g, device=dev) < 0.5,
                                  0.0, -1e9)
            c = torch.tensor([1, 15, 16, 17, 33, 64, 65, 128], dtype=torch.int32, device=dev)
            lv_lo = torch.tensor([0, 15, 17, 1, 31, 64, 100, 0], dtype=torch.int32, device=dev)
            lv_hi = torch.tensor([1, 17, 33, 215, 65, 129, 101, 336], dtype=torch.int32,
                                 device=dev)
            args = (q, sh, sh_mask, lv, lv_mask, c, lv_lo, lv_hi)
            compare("flash_decode_two_phase",
                    f"edges R={R} H={H} K={Kq} shared int8={sh_int8} live int8={lv_int8}",
                    dtype, flash_decode_two_phase(*args, shared_scales=sh_s, live_scales=lv_s),
                    flash_decode_two_phase_ref(*args, shared_scales=sh_s, live_scales=lv_s))


MANUAL_SLOTS = ("2", "3", "4")       # the manual kernel's ring depths


def check_manual_edges(q, kv, mask, lo, hi, label, dtype, compare):
    """Phase 2, the manual-pipeline kernel at ring depths 2, 3 and 4 at the
    chunk-cutting bounds (host, from 17, and per row ``[lo, hi)``, strided
    and tile-major); then the same per-row bounds over a cache and a mask
    that hold NaN outside each row's bounds, against the twin on the clean
    ones: the output must stay finite (the kernel reads only ``[lo, hi)``)."""
    from clipcap_tpu_torch.ops.flash_decode import flash_decode, flash_decode_ref

    R, U = kv.shape[0], kv.shape[2]
    kv5 = tile_major(kv, 64)
    slot = torch.arange(U, device=kv.device)
    outside = (slot < lo[:, None]) | (slot >= hi[:, None])                    # [R, U]
    dirty = kv.masked_fill(outside[:, None, :, None], float("nan"))
    dirty_mask = mask.masked_fill(outside[:, None, :], float("nan"))
    cases = [(None, b) for b in EDGES] + [(17, 215), (lo, hi)]
    for slots in MANUAL_SLOTS:
        with mock.patch.dict(os.environ, {"CLIPCAP_FLASH_MANUAL_SLOTS": slots}):
            for u_lo, u_valid in cases:
                want = flash_decode_ref(q, kv, mask, u_valid, u_lo=u_lo)
                bounds = "per-row [lo, hi)" if u_lo is lo else f"[{u_lo or 0}, {u_valid})"
                for form, kvx in (("strided", kv), ("tile-major", kv5)):
                    compare("flash_decode_manual", f"{label} {bounds} {form} S={slots}", dtype,
                            flash_decode(q, kvx, mask, u_valid, u_lo=u_lo, manual=True), want)
            want = flash_decode_ref(q, kv, mask, hi, u_lo=lo)
            for form, kvx in (("strided", dirty), ("tile-major", tile_major(dirty, 64))):
                got = flash_decode(q, kvx, dirty_mask, hi, u_lo=lo, manual=True)
                if not torch.isfinite(got.float()).all():
                    raise AssertionError(f"flash_decode_manual {label} NaN outside [lo, hi) "
                                         f"{form} S={slots}: the output is not finite")
                compare("flash_decode_manual", f"{label} NaN outside per-row [lo, hi) {form} "
                        f"S={slots}", dtype, got, want)


# fused_sdpa's phase-2 shapes: (B, H, N, causal).
FUSED_SHAPES = ((8, 12, 50, False), (5, 8, 77, True), (32, 16, 257, False), (4, 16, 512, False))

# The attention kernel's edge cases in phase 2: rows that end a query tile
# or a 16-key block, or fall one short or one past (N = 1, 63, 64, 65), the
# towers' rows (257, 577; 577 for the packed form only: fused_sdpa stops at
# 512), and (B, H, N) = (64, 16, 65): 1,024 heads, so that the persistent
# grid (one block an SM) walks its heads more than once.
ATTENTION_EDGE_N = (1, 63, 64, 65, 257, 577)


def check_attention_edges(dev, g, dtype, compare):
    """Phase 2, ``sdpa_packed`` and ``fused_sdpa`` at the tail rows of
    ``ATTENTION_EDGE_N``, with and without causal; a grid that wraps; rows
    longer than shared memory holds (N = 900: K and V through the ring);
    scales of either sign and 0 (the kernel folds the scale into the
    exponent); and operands at the start of buffers filled with NaN past
    their end (TMA reads nothing outside an operand: the output must be
    finite and equal to the twin's)."""
    from clipcap_tpu_torch.ops.attention import (fused_sdpa, fused_sdpa_ref, sdpa_packed,
                                                 sdpa_packed_ref)

    H = 4
    cases = [(3, N, causal) for N in ATTENTION_EDGE_N for causal in (False, True)]
    cases += [(64, 65, False), (2, 900, False), (2, 900, True)]
    for B, N, causal in cases:
        heads = 16 if B == 64 else H
        qkv = torch.randn(B, N, 3 * heads * 64, generator=g, device=dev).to(dtype)
        compare("sdpa_packed", f"edge B={B} N={N} H={heads} causal={causal}", dtype,
                sdpa_packed(qkv, heads, causal=causal), sdpa_packed_ref(qkv, heads, causal=causal))
        if N <= 512:
            q, k, v = (torch.randn(B, heads, N, 64, generator=g, device=dev).to(dtype)
                       for _ in range(3))
            compare("fused_sdpa", f"edge B={B} H={heads} N={N} causal={causal}", dtype,
                    fused_sdpa(q, k, v, causal=causal), fused_sdpa_ref(q, k, v, causal=causal))
    qkv = torch.randn(3, 130, 3 * H * 64, generator=g, device=dev).to(dtype)
    for scale in (-0.2, 0.0, 0.5):
        compare("sdpa_packed", f"scale={scale} B=3 N=130 H={H} causal=True", dtype,
                sdpa_packed(qkv, H, scale=scale, causal=True),
                sdpa_packed_ref(qkv, H, scale=scale, causal=True))
    B, N = 3, 65
    size = B * N * 3 * H * 64
    buf = torch.full((size + 4096,), float("nan"), dtype=dtype, device=dev)
    qkv = buf[:size].view(B, N, 3 * H * 64)
    qkv.copy_(torch.randn(B, N, 3 * H * 64, generator=g, device=dev))
    ops = []
    for _ in range(3):
        b = torch.full((B * H * N * 64 + 4096,), float("nan"), dtype=dtype, device=dev)
        ops.append(b[:B * H * N * 64].view(B, H, N, 64))
        ops[-1].copy_(torch.randn(B, H, N, 64, generator=g, device=dev))
    for causal in (False, True):
        got = sdpa_packed(qkv, H, causal=causal)
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"sdpa_packed read past its operand (causal={causal})")
        compare("sdpa_packed", f"NaN past the operand B={B} N={N} causal={causal}", dtype, got,
                sdpa_packed_ref(qkv, H, causal=causal))
        got = fused_sdpa(*ops, causal=causal)
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"fused_sdpa read past its operands (causal={causal})")
        compare("fused_sdpa", f"NaN past the operands B={B} N={N} causal={causal}", dtype, got,
                fused_sdpa_ref(*ops, causal=causal))


# Patch-embed shapes: (batch, image side, patch, width).
PATCH_SHAPES = {"ViT-L/14 b256": (256, 224, 14, 1024), "ViT-B/32 b512": (512, 224, 32, 768),
                "ViT-L/14@336px b256": (256, 336, 14, 1024)}


def patch_inputs(g, B, S, P, D, dev):
    """Seeded uint8 images [B, S, S, 3], a bf16 [3P², D] weight and bias."""
    imgs = torch.randint(0, 256, (B, S, S, 3), generator=g, device=dev, dtype=torch.uint8)
    w = (torch.randn(3 * P * P, D, generator=g, device=dev) * 0.01).to(torch.bfloat16)
    # A bias the size of the outputs: dropping or mis-indexing it misses by
    # about ten times the tolerance.
    bias = (torch.randn(D, generator=g, device=dev) * 5).to(torch.bfloat16)
    return imgs, w, bias


# Phase 2's patch-embed cases beyond the main shapes: (label, batch, image
# side, patch, width).  The kernel's tiles are 128 patches x 256 columns.
PATCH_CASES = (
    ("odd batch", 3, 224, 32, 768), ("odd batch", 3, 224, 14, 1024),   # M = 147, 768
    ("test-tiny", 3, 32, 16, 64),                                       # D = 64 of 256
    ("width 320", 2, 224, 14, 320),                                     # D ragged
    ("multi-round", 40, 224, 14, 320),          # 160 tiles: two rounds of the grid
    ("ViT-B/16", 5, 224, 16, 768),
    ("28 px", 2, 28, 14, 64),                   # patch rows of 1,176 bytes: bytes path
    ("unaligned", 3, 224, 14, 320), ("unaligned", 3, 224, 16, 768),
    ("unaligned", 3, 224, 32, 768),             # batches off 16 bytes: bytes path
    ("all 255", 4, 224, 14, 1024), ("all 255", 4, 224, 32, 768),        # the widening's top
    ("odd patch", 2, 112, 7, 64), ("odd patch", 2, 28, 7, 64),          # both pixel paths
    # 336 px: a tile's 6 patch rows (84,672 bytes) fit once, so the pixel
    # ring has one stage; M = 1,728 ends inside a tile.
    ("336 px", 3, 336, 14, 1024), ("unaligned", 3, 336, 14, 1024),
)


def check_patch_embed(dev, g) -> float:
    """Phase 2, the patch-embed kernel against its twin: the timed shapes
    (``PATCH_SHAPES``) and ``PATCH_CASES`` (ragged M and D against the 128 x
    256 tile, two rounds of the persistent grid, both pixel paths at P =
    14, 16, 32 and 7 and at 336 px, 255 in every pixel), with and without
    bias.  Tolerance one bf16
    ulp of the largest output: both sum the same bf16 products in fp32 in
    another order and round once."""
    from clipcap_tpu_torch.ops.patch_embed import patch_embed, patch_embed_ref, pixel_path

    cases = [(label, *shape) for label, shape in PATCH_SHAPES.items()] + list(PATCH_CASES)
    worst = 0.0
    for label, B, S, P, D in cases:
        imgs, w, bias = patch_inputs(g, B, S, P, D, dev)
        if label == "all 255":
            imgs.fill_(255)
        if label == "unaligned":
            flat = torch.empty(imgs.numel() + 1, dtype=torch.uint8, device=dev)
            imgs = flat[1:].view_as(imgs).copy_(imgs)
        path = pixel_path(imgs.shape, P, imgs.data_ptr())
        # What a kernel that dropped the bias would miss by.
        miss = (patch_embed_ref(imgs, w, bias, P).float()
                - patch_embed_ref(imgs, w, None, P).float()).abs().max().item()
        for b in (bias, None):
            want = patch_embed_ref(imgs, w, b, P).float()
            d = (patch_embed(imgs, w, b, P).float() - want).abs().max().item()
            tol = 2 ** -7 * want.abs().max().item()
            print(f"kernel patch_embed {label} B={B} {S}x{S} P={P} D={D} pixel path {path} "
                  f"bias={b is not None}: max|d| {d:.3g} (tol {tol:.3g}; a dropped bias: "
                  f"{miss:.3g})")
            if not d <= tol:
                raise AssertionError(f"patch_embed {label}: max|d| {d} over {tol}")
            worst = max(worst, d)
    return worst


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
    from clipcap_tpu_torch.ops.attention import (fused_sdpa, fused_sdpa_ref, sdpa_packed,
                                                 sdpa_packed_ref)
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
        **timed(lambda: flash_decode(q, kv, mask, u)),
        **timed(lambda: flash_decode_ref(q, kv, mask, u), "plain_"),
        **timed(lambda: F.scaled_dot_product_attention(
            q, kv[:, :, :u, :64], kv[:, :, :u, 64:], attn_mask=lib_mask), "library_"),
        **decode_bound(q, [(R * u, 256, R * u)], bf)}
    print(f"time [{tag}] flash_decode beam R={R} H={H} K={K} u_valid={u} bf16: "
          f"{out['flash_decode']}")
    # The row of the kernels JSON is ViT-B/32 b512 (the captioning slice);
    # ViT-L/14 b256 (N = 257) is the preprocess path's shape, ViT-L/14@336px
    # (N = 577) the longest row a tower takes.  Bound: q, k, v read and the
    # context written once; 4·N²·D operations per sample (about half of
    # them under causal: 4·N(N+1)/2·D).  Device clock for the kernel (one
    # launch: its traces count only it), the twin and SDPA; the kernel also
    # with the L2 flushed before each call (the text tower's qkv fits in the
    # 50 MB L2 back to back; the towers' batches, 118-908 MB, do not).
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)

    def attention_times(kernel, twin, library, B, N, D, causal):
        t = {"ms": cuda_ms(kernel), "device_ms": device_ms(kernel, only="sdpa"),
             **timed(twin, "plain_"), **timed(library, "library_"),
             "cold_device_ms": device_ms(lambda: (flush.zero_(), kernel()), only="sdpa"),
             **attention_bound(B, N, D, causal)}
        clock = "device_ms" if t["device_ms"] is not None else "ms"
        pairs = N * (N + 1) // 2 if causal else N * N
        t.update(tflops=4 * B * pairs * D / t[clock] / 1e9, tflops_clock=clock)
        return t

    for B, N, D, H, causal, label, key in (
            (512, 50, 768, 12, False, "ViT-B/32 b512", "sdpa_packed"),
            (5, 77, 512, 8, True, "text tower b5", "sdpa_packed_text_b5"),
            (256, 257, 1024, 16, False, "ViT-L/14 b256", "sdpa_packed_vit_l14"),
            (256, 577, 1024, 16, False, "ViT-L/14@336px b256", "sdpa_packed_vit_l14_336")):
        qkv = torch.randn(B, N, 3 * D, generator=g, device=dev).to(bf)
        heads = qkv.view(B, N, 3, H, D // H).permute(2, 0, 3, 1, 4)
        out[key] = t = attention_times(
            lambda: sdpa_packed(qkv, H, causal=causal),
            lambda: sdpa_packed_ref(qkv, H, causal=causal),
            lambda: F.scaled_dot_product_attention(*heads, is_causal=causal), B, N, D, causal)
        print(f"time [{tag}] sdpa_packed {label} bf16: {t}; {t['tflops']:.1f} TFLOP/s "
              f"({t['tflops_clock']})")
        del qkv, heads
        torch.cuda.empty_cache()
    # fused_sdpa, head-major: its row is ViT-L/14 b256 (the façade's call in
    # phase 3), ViT-B/32 b512 beside it.
    for B, H, N, label, key in ((512, 12, 50, "ViT-B/32 b512", "fused_sdpa_vit_b32"),
                                (256, 16, 257, "ViT-L/14 b256", "fused_sdpa")):
        q, k, v = (torch.randn(B, H, N, 64, generator=g, device=dev).to(bf) for _ in range(3))
        out[key] = t = attention_times(
            lambda: fused_sdpa(q, k, v), lambda: fused_sdpa_ref(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v), B, N, H * 64, False)
        print(f"time [{tag}] fused_sdpa {label} [{B}, {H}, {N}, 64] bf16: {t}; "
              f"{t['tflops']:.1f} TFLOP/s ({t['tflops_clock']})")
        del q, k, v
    return out


def ratio(a, b):
    """a / b where both were measured, else None."""
    return a / b if a and b else None


def attention_bound(B: int, N: int, D: int, causal: bool) -> dict:
    """Bound of one bf16 encoder-attention call over B samples of N rows and
    D = H·64 columns."""
    pairs = N * (N + 1) // 2 if causal else N * N
    return bound(4 * B * N * D * 2, 4 * B * pairs * D, torch.bfloat16)


def run_sdpa_facade(dev):
    """Phase 3b: the JAX package's attention façade, ``sdpa(q, k, v)`` on
    [B, N, H, Dh] bf16 at ViT-L/14 width (b256, N = 257, 16 heads), the
    count set to 0 just before.  Returns (fused_sdpa launches, max |Δ|
    against the twin)."""
    from clipcap_tpu_torch.ops.attention import fused_sdpa, fused_sdpa_ref, sdpa

    g = torch.Generator(device=dev).manual_seed(8)
    B, N, H = 256, 257, 16
    q, k, v = (torch.randn(B, N, H, 64, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    fused_sdpa.launches = 0
    got = sdpa(q, k, v)
    torch.cuda.synchronize()
    launches = fused_sdpa.launches
    want = fused_sdpa_ref(*(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)
    d = (got.float() - want.reshape(B, N, H * 64).float()).abs().max().item()
    print(f"facade: sdpa(q, k, v) [{B}, {N}, {H}, 64] bf16 -> {tuple(got.shape)}; fused_sdpa "
          f"launches {launches}; max|d| against the twin {d:.3g} (tol {TOL[torch.bfloat16]})")
    if launches == 0:
        raise AssertionError("the sdpa facade never launched the fused_sdpa kernel")
    if got.shape != (B, N, H * 64) or not d <= TOL[torch.bfloat16]:
        raise AssertionError(f"sdpa facade: shape {tuple(got.shape)}, max|d| {d}")
    return launches, d


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
        **timed(lambda: flash_decode(q, rows, mask, u, scales=scales)),
        **timed(lambda: flash_decode_ref(q, rows, mask, u, scales=scales), "plain_"),
        "library_ms": None, **decode_bound(q, [(R * u, 136, R * u)], bf)}}
    print(f"time [{tag}] flash_decode_int8 beam R={R} H={H} K={K} u_valid={u} bf16 q: "
          f"{out['flash_decode_int8']}")
    for int8 in (False, True):
        args, kw = two_phase_inputs(g, bf, step, int8, int8, dev)
        c, lv_lo, lv_hi = args[5], args[6], args[7]
        shared_slots = int((c.sum()).item())
        live_slots = int((lv_hi - lv_lo).sum().item())
        slot_bytes = 136 if int8 else 256
        t = {**timed(lambda: flash_decode_two_phase(*args, **kw)),
             **timed(lambda: flash_decode_two_phase_ref(*args, **kw), "plain_"),
             "library_ms": None,
             **decode_bound(q, [(shared_slots, slot_bytes, shared_slots),
                                (live_slots, slot_bytes, live_slots)], bf)}
        print(f"time [{tag}] flash_decode_two_phase R={R} H={H} K={K} step {step} int8={int8} "
              f"({shared_slots} shared + {live_slots} live slots over the rows): {t}")
        out.setdefault("flash_decode_two_phase", t)
    return out


def time_patch_embed(dev, tag: str):
    """Phase 8e: the patch-embed kernel against its twin, ``F.conv2d`` (the
    library call: a bf16 NCHW image, a layout the port never holds, and
    the folded weight as a stride-P convolution) and the eager cast +
    ``patchify`` + ``linear`` route, at each shape and on both clocks; the
    kernel with the L2 flushed before each call (cold: back to back, the
    50 MB L2 holds ViT-L/14's 38.5 MB batch).  The row of the kernels JSON
    is ViT-L/14 b256, the main path's shape, with ViT-B/32 b512 and
    ViT-L/14@336px b256 beside it."""
    import torch.nn.functional as F

    from clipcap_tpu_torch.ops.layers import linear
    from clipcap_tpu_torch.ops.patch_embed import patch_embed, patch_embed_ref, patchify

    g = torch.Generator(device=dev).manual_seed(6)
    bf = torch.bfloat16
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}
    for label, (B, S, P, D) in PATCH_SHAPES.items():
        imgs, w, bias = patch_inputs(g, B, S, P, D, dev)
        nchw = imgs.permute(0, 3, 1, 2).to(bf).contiguous()
        conv_w = w.t().reshape(D, 3, P, P).contiguous()
        M, K = B * (S // P) ** 2, 3 * P * P

        def kernel():
            return patch_embed(imgs, w, bias, P)

        # The kernel is one launch: its traces count only it, so a kernel
        # still running from earlier work adds nothing.
        t = {"ms": cuda_ms(kernel), "device_ms": device_ms(kernel, only="patch_embed"),
             **timed(lambda: patch_embed_ref(imgs, w, bias, P), "plain_"),
             **timed(lambda: F.conv2d(nchw, conv_w, bias, stride=P), "library_"),
             **timed(lambda: linear(patchify(imgs.to(bf), P), w, bias), "eager_"),
             "cold_device_ms": device_ms(lambda: (flush.zero_(), kernel()), only="patch_embed"),
             **bound(imgs.numel() + 2 * (w.numel() + D + M * D), 2 * M * K * D, bf)}
        # A trace can come back without device events (device_ms None):
        # then the rate is on the CUDA-event clock, and says so.
        clock = "device_ms" if t["device_ms"] is not None else "ms"
        t.update(tflops=2 * M * K * D / t[clock] / 1e9, tflops_clock=clock)
        print(f"time [{tag}] patch_embed {label} (M={M}, K={K}, D={D}): {t}; "
              f"{t['tflops']:.1f} TFLOP/s ({clock}); library is F.conv2d on a bf16 NCHW copy, "
              f"not the uint8 NHWC input")
        rows[label] = t
    return {**rows["ViT-L/14 b256"], "vit_b32_b512": rows["ViT-B/32 b512"],
            "vit_l14_336_b256": rows["ViT-L/14@336px b256"]}


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
    from clipcap_tpu_torch.ops.quick_gelu import quick_gelu
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
    quick_gelu.launches = 0
    t0 = time.perf_counter()
    sample = transform(str(image))
    embedding = encoder(sample[None])
    tower_quick_gelu = quick_gelu.launches
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
    print(f"slice: the ViT-B/32 tower call launched quick_gelu {tower_quick_gelu} times "
          f"(gate: its {encoder.config.vision.layers} blocks)")
    if tower_quick_gelu != encoder.config.vision.layers:
        raise AssertionError(f"slice: {tower_quick_gelu} quick_gelu launches in a tower call of "
                             f"{encoder.config.vision.layers} blocks")
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

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # A span's device range (``annotate``) spans its kernels: count the kernels only.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)]
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
    del kernels, prof
    gc.collect()                  # the trace's events hold reference cycles


def host_memory() -> str:
    """The process's resident and peak host memory, from /proc/self/status
    (the machine's memory limit counts the files the run writes too)."""
    status = Path("/proc/self/status")
    if not status.exists():
        return "host memory not reported"
    fields = dict(line.split(":", 1) for line in status.read_text().splitlines() if ":" in line)
    return (f"host memory: resident {fields.get('VmRSS', '?').strip()}, peak "
            f"{fields.get('VmHWM', '?').strip()}")


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


def train_cli(dev, root: Path, out: Path, label: str, extra, embedding, model_args=MODEL_ARGS,
              start=None, rows: int = TRAIN_ROWS):
    """Phase 6b: one run of ``clipcap_tpu_torch.train``'s entry point (or
    ``start``, another entry point that takes the same argv) on the card,
    then its final checkpoint through ``load`` and ``generate_beam``.
    Returns the fused-AdamW launches of the run."""
    from clipcap_tpu_torch import generate_beam, load
    from clipcap_tpu_torch.ops.fused_adamw import fused_adamw
    from clipcap_tpu_torch.train.train import start_training

    start = start or start_training

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
        rc = start(argv)
    sync(dev)
    launches = fused_adamw.launches
    seconds = time.perf_counter() - t0
    losses = [float(x) for x in re.findall(r" loss (\S+) ", log.getvalue())]
    steps = math.ceil(rows / TRAIN_BATCH)
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


# The decode forms of phase 7: (tile-major cache, manual-pipeline kernel).
FORMS = {"strided": (False, False), "tm": (True, False), "man": (False, True),
         "mantm": (True, True)}


def decode_form(form: str):
    """The environment of a decode form: ``CLIPCAP_FLASH_MANUAL`` as the
    form says (the cache layout goes through ``BeamParams.tile_major``)."""
    return mock.patch.dict(os.environ, {"CLIPCAP_FLASH_MANUAL": "1" if FORMS[form][1] else "0"})


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

    def run(int8: bool, C: int, mode: str = "kernel", x=prefix, form: str = "strided"):
        bp = BeamParams(beam_size=K, max_new_tokens=N_NEW, stop_token=50256, int8_kv=int8,
                        consolidate_every=C, tile_major=FORMS[form][0])
        n0 = flash_decode.launches + flash_decode_two_phase.launches
        diffs = []
        with contextlib.ExitStack() as patches:
            patches.enter_context(decode_form(form))
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
    # The decode forms at C = 0: the strided cache through the auto kernel
    # (bf_c0), the tile-major cache, the manual-pipeline kernel, both.
    for form in ("tm", "man", "mantm"):
        n0 = flash_decode.manual_launches
        res = run(False, 0, form=form)
        manual = flash_decode.manual_launches - n0
        same = torch.equal(res.tokens, bf_c0.tokens)
        print(f"xl: fp32 R=4 C=0 form {form} vs strided/auto: {agreement(res, bf_c0)}; max|d "
              f"score| {(res.scores - bf_c0.scores).abs().max().item():.3g}; manual-pipeline "
              f"launches {manual}")
        if not same or (manual > 0) != FORMS[form][1]:
            raise AssertionError(f"xl fp32 form {form}: tokens equal {same}, {manual} manual "
                                 "launches")
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


def int8_cli(slice_dir: Path, dev, flag: str = "--int8-kv-cache"):
    """Phase 7c: ``python -m clipcap_tpu_torch.inference --int8-kv-cache``'s
    function on the GPT-2 124M checkpoint of phase 3 (phase 10b:
    ``--int8-weights``)."""
    from argparse import ArgumentParser

    from clipcap_tpu_torch.inference.args import add_inference_args
    from clipcap_tpu_torch.inference.demo import inference_demo

    args = add_inference_args(ArgumentParser()).parse_args(
        ["--model-path", str(slice_dir / "model.npz"), "--config-path",
         str(slice_dir / "config.yaml"), "--sample-path", str(slice_dir / "image.png"),
         "--device", str(dev), flag, "--number-to-generate", "5"])
    log = io.StringIO()
    with warnings.catch_warnings(), contextlib.redirect_stdout(log):
        warnings.simplefilter("ignore")               # seeded CLIP: no checkpoint offline
        rc = inference_demo(args)
    lines = log.getvalue().splitlines()
    if rc != 0 or sum(line.startswith("sim ") for line in lines) != 5 or "best" not in lines[-1]:
        raise AssertionError(f"int8 CLI {flag}: exit {rc}, output {lines}")
    print(f"xl: CLI {flag} on the GPT-2 124M checkpoint: 5 captions; {lines[-1]!r}")


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
    medians, peaks = {}, {}
    for int8, C in ((False, 0), (True, 0), (False, 8), (True, 8)):
        bp = BeamParams(beam_size=K, max_new_tokens=N_NEW, stop_token=50256, int8_kv=int8,
                        consolidate_every=C)

        def work(x, bp=bp):
            return beam_search_batched(lm, x, bp, dtype=bf)

        torch.cuda.reset_peak_memory_stats()
        cps = rate(work, inputs, XL_BATCH, trials=2)
        medians[int8, C] = statistics.median(cps)
        peaks[int8, C] = torch.cuda.max_memory_allocated() / 2**30
        print(f"time [{tag}] beam-5 GPT-2 XL b{XL_BATCH} bf16 int8_kv={int8} "
              f"consolidate_every={C}: captions/s per trial {cps}; median "
              f"{medians[int8, C]:.2f}; peak device memory {peaks[int8, C]:.2f} GiB")
        if (int8, C) == (True, 0):
            profile_xl_steps(lm, inputs[0], f"beam-5 GPT-2 XL b{XL_BATCH} int8 C=0", tag)
    form_launches = xl_forms(lm, prefix, tag)
    times = time_kv_kernels(dev, tag)
    times.update(time_manual_kernels(dev, tag))
    print(f"xl: phase took {time.perf_counter() - t_phase:.1f} s")
    rows = {name: {"launches": launches[name], **times[name]} for name in launches}
    rows["flash_decode_tile_major"] = {"launches": form_launches["tm"],
                                       **times["flash_decode_tile_major"]}
    rows["flash_decode_manual"] = dict(times["flash_decode_manual"],
                                       xl_b96_launches={f: form_launches[f]
                                                        for f in ("man", "mantm")})
    return rows, {key: (medians[key], peaks[key]) for key in ((False, 0), (True, 0))}


def profile_xl_steps(lm, prefix, label: str, tag: str):
    """One beam-5 batch with the int8 cache at C = 0, cut to 8 new tokens,
    under the profiler (phase 7, and 10b with int8 weights): the trace of a
    whole 67-token batch takes over a minute to read back, and 8 tokens show
    the same steps.  The idle share is against the same cut batch
    unprofiled."""
    from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched

    bp = BeamParams(beam_size=K, max_new_tokens=8, stop_token=50256, int8_kv=True)

    def work(x):
        return beam_search_batched(lm, x, bp, dtype=torch.bfloat16)

    work(prefix)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    work(prefix)
    torch.cuda.synchronize()
    profile(work, prefix, (time.perf_counter() - t0) * 1e3, f"{label}, 8 new tokens", tag)


def xl_forms(lm, prefix, tag: str):
    """Phase 7e: beam 5 at b96 bf16 in the four decode forms: the strided
    cache through the auto kernel, the tile-major cache (``tm``), the
    manual-pipeline kernel (``man``) and both (``mantm``).  Each form's
    first batch is a path of its own: the counts are set to 0 just before
    and read just after; the manual forms must launch only the manual
    kernel, the others never.  Then one batch of each form in turns,
    forward and back (host-bound rates drift within a call), for
    captions/s and peak memory.  Returns each form's launches (of the
    manual kernel in the manual forms, of the auto kernel otherwise)."""
    from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
    from clipcap_tpu_torch.ops.flash_decode import flash_decode

    def work(form):
        bp = BeamParams(beam_size=K, max_new_tokens=N_NEW, stop_token=50256,
                        tile_major=FORMS[form][0])
        with decode_form(form):
            beam_search_batched(lm, prefix, bp, dtype=torch.bfloat16)
        torch.cuda.synchronize()

    out = {}
    for form in FORMS:
        flash_decode.launches = flash_decode.manual_launches = 0
        work(form)
        launches, manual = flash_decode.launches, flash_decode.manual_launches
        out[form] = manual if FORMS[form][1] else launches
        if launches == 0 or manual != (launches if FORMS[form][1] else 0):
            raise AssertionError(f"xl form {form}: {launches} launches, {manual} manual")
    rates = {form: [] for form in FORMS}
    peak = dict.fromkeys(FORMS, 0)
    for form in [*FORMS, *reversed(FORMS)]:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        work(form)
        rates[form].append(XL_BATCH / (time.perf_counter() - t0))
        peak[form] = max(peak[form], torch.cuda.max_memory_allocated())
    for form in FORMS:
        print(f"time [{tag}] beam-5 GPT-2 XL b{XL_BATCH} bf16 C=0 form {form}: captions/s per "
              f"trial {rates[form]} (in turns: strided, tm, man, mantm, then back); median "
              f"{statistics.median(rates[form]):.2f}; peak device memory "
              f"{peak[form] / 2**30:.2f} GiB; launches of the path {out[form]}")
    return out


# The bf16 manual kernel's design, as its row records it: of the variants
# timed side by side (PERF.md §6), the one that is built.
MANUAL_DESIGN = ("persistent grid of two-warp blocks; each warp feeds its own ring with a "
                 "1-D bulk copy per slot under mbarriers; tensor-core fold")


def time_manual_kernels(dev, tag: str):
    """Phase 7f: the manual-pipeline kernel (S = 2, 3 and 4, strided and
    tile-major) beside the auto kernel (row 1, strided and tile-major), the
    twin and ``F.scaled_dot_product_attention`` on the strided view, at
    beam step 40 of GPT-2 b128 (H = 12) and GPT-2 XL b96 (H = 25), bf16,
    u_valid 215 of 384 slots; and each bound.  The kernels JSON rows are
    R = 128 S = 2 strided (the manual kernel) and R = 128 tile-major (the
    auto kernel's tile-major form), with the rest beside them; the manual
    row records its design and, per layout, its device time over the auto
    kernel's in the same call (below 1: the manual kernel won)."""
    import torch.nn.functional as F

    from clipcap_tpu_torch.models.gpt2 import beam_mask
    from clipcap_tpu_torch.ops.flash_decode import flash_decode, flash_decode_ref

    g = torch.Generator(device=dev).manual_seed(9)
    bf, step, U, u_tile = torch.bfloat16, 40, 384, 64
    manual_row, tm_row = {}, {}
    for R, H, key in ((128, 12, "r128"), (XL_BATCH, XL_HEADS, "xl_r96")):
        q = torch.randn(R, H, K, 64, generator=g, device=dev).to(bf)
        kv = torch.randn(R, H, U, 128, generator=g, device=dev).to(bf)
        kv5 = tile_major(kv, u_tile)
        anc = torch.randint(0, K, (R * K, N_NEW), generator=g, device=dev)
        mask = beam_mask(anc, K, U, offset=P + step, cache_base=P)
        u = P + (step + 1) * K
        lib_mask = mask[:, None, :, :u].to(bf)
        t = {**timed(lambda: flash_decode(q, kv, mask, u, manual=False), "auto_strided_"),
             **timed(lambda: flash_decode(q, kv5, mask, u, manual=False), "auto_tile_major_")}
        for slots in MANUAL_SLOTS:
            with mock.patch.dict(os.environ, {"CLIPCAP_FLASH_MANUAL_SLOTS": slots}):
                for form, kvx in (("strided", kv), ("tile_major", kv5)):
                    t.update(timed(lambda: flash_decode(q, kvx, mask, u, manual=True),
                                   f"manual_S{slots}_{form}_"))
        t.update(timed(lambda: flash_decode_ref(q, kv, mask, u), "plain_"))
        t.update(timed(lambda: F.scaled_dot_product_attention(
            q, kv[:, :, :u, :64], kv[:, :, :u, 64:], attn_mask=lib_mask), "library_"))
        t.update(decode_bound(q, [(R * u, 256, R * u)], bf))
        print(f"time [{tag}] flash_decode forms beam R={R} H={H} K={K} u_valid={u} of {U} "
              f"bf16: {t}")
        common = {k: t[k] for k in ("plain_ms", "plain_device_ms", "library_ms",
                                    "library_device_ms", "bound_ms", "bound_by")}
        manual = {"ms": t["manual_S2_strided_ms"],
                  "device_ms": t["manual_S2_strided_device_ms"], **common,
                  **{k: t[k] for k in t if k.startswith(("manual", "auto"))},
                  "design": MANUAL_DESIGN,
                  "over_auto": {form: ratio(t[f"manual_S2_{form}_device_ms"],
                                            t[f"auto_{form}_device_ms"])
                                for form in ("strided", "tile_major")}}
        print(f"time [{tag}] flash_decode_manual R={R} H={H} S=2 device time over the auto "
              f"kernel's: {manual['over_auto']}")
        tm = {"ms": t["auto_tile_major_ms"], "device_ms": t["auto_tile_major_device_ms"],
              **common, "auto_strided_ms": t["auto_strided_ms"],
              "auto_strided_device_ms": t["auto_strided_device_ms"]}
        if key == "r128":
            manual_row, tm_row = manual, tm
        else:
            manual_row[key], tm_row[key] = manual, tm
    return {"flash_decode_manual": manual_row, "flash_decode_tile_major": tm_row}


PRE_FILES, PRE_WDS, PRE_BATCH, PRE_DIM, PRE_VARIANT = 1024, 256, 256, 768, "ViT-L_14"


def write_preprocess_inputs(root: Path):
    """Phase 8a: seeded noise JPEGs, half 256x320 and half 320x256 (so the
    transform resizes and crops both ways): 1,024 with ``.txt`` captions in
    a folder, 256 in a webdataset shard with ``json/caption`` metadata.
    Returns the captions of each in key order."""
    import tarfile

    from PIL import Image

    rng = np.random.default_rng(0)

    def jpeg(i):
        shape = (256, 320, 3) if i % 2 else (320, 256, 3)
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(buf, format="JPEG",
                                                                          quality=90)
        return buf.getvalue()

    files, wds = root / "files", root / "wds"
    files.mkdir(parents=True)
    wds.mkdir()
    file_captions = [f"seeded noise image {i}, {'wide' if i % 2 else 'tall'}"
                     for i in range(PRE_FILES)]
    for i, text in enumerate(file_captions):
        (files / f"img_{i:05d}.jpg").write_bytes(jpeg(i))
        (files / f"img_{i:05d}.txt").write_text(text)
    wds_captions = [f"webdataset noise image {i}" for i in range(PRE_WDS)]
    with tarfile.open(wds / "shard-0000.tar", "w") as tar:
        for i, text in enumerate(wds_captions):
            for name, data in ((f"{i:06d}.jpg", jpeg(PRE_FILES + i)),
                               (f"{i:06d}.json", json.dumps({"caption": text}).encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    return file_captions, wds_captions


def preprocess_cli(dev, label: str, argv, built: list, n: int, variant: str = PRE_VARIANT,
                   batch: int = PRE_BATCH, unit: str = "images"):
    """Phase 8b: one run of ``clipcap_tpu_torch.preprocess``'s entry point;
    the encoder it builds is kept in ``built``.  Prints items/s end to end
    (encoder build included) and the runner's split, and returns the
    runner's split in seconds."""
    import importlib

    from clipcap_tpu_torch.encoders.base import get_encoder_from_config

    pre_mod = importlib.import_module("clipcap_tpu_torch.preprocess.preprocess")

    def recording(*args, **kwargs):
        built.append(get_encoder_from_config(*args, **kwargs))
        return built[-1]

    log = io.StringIO()
    t0 = time.perf_counter()
    with warnings.catch_warnings(), contextlib.redirect_stdout(_Tee(sys.stdout, log)), \
            mock.patch.object(pre_mod, "get_encoder_from_config", recording):
        warnings.simplefilter("ignore")               # seeded CLIP: no checkpoint offline
        rc = pre_mod.start_preprocess([*argv, "--encoder-model-variant", variant,
                                       "--batch-size", str(batch), "--device", str(dev)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    split = {}
    for text in re.findall(r"^partition \d+: .*; (.*)\)$", log.getvalue(), re.M):
        for name, secs in re.findall(r"([\w/]+) ([\d.]+)s", text):
            split[name] = round(split.get(name, 0.0) + float(secs), 3)
    print(f"preprocess ({label}): exit {rc}; {n} {unit} in {seconds:.1f} s end to end, encoder "
          f"build included ({n / seconds:.1f} {unit}/s); runner {split} s "
          f"({n / max(sum(split.values()), 1e-9):.1f} {unit}/s)")
    if rc != 0:
        raise AssertionError(f"preprocess ({label}): exit {rc}")
    return split


def check_dataset(out: Path, partitions: list, label: str, dim: int = PRE_DIM,
                  variant: str = PRE_VARIANT):
    """Phase 8c: the layout the JAX package writes; ``partitions`` holds
    each partition's source captions in key order."""
    import pandas as pd
    import yaml

    config = yaml.safe_load((out / "encoder_config.yaml").read_text())
    if (config["encoder_embedding_size"], config["encoder_model_variant"]) != (dim, variant):
        raise AssertionError(f"preprocess ({label}): encoder_config.yaml {config}")
    for i, captions in enumerate(partitions):
        e = np.load(out / "embeddings" / f"embeds_{i}.npy")
        got = list(pd.read_parquet(out / "captions" / f"captions_{i}.parquet")["caption"])
        if e.dtype != np.float32 or e.shape != (len(captions), dim) \
                or not np.isfinite(e).all():
            raise AssertionError(f"preprocess ({label}): embeds_{i} {e.dtype} {e.shape}")
        if got != captions:
            raise AssertionError(f"preprocess ({label}): captions_{i} differ from the sources")
    print(f"preprocess ({label}): {[len(c) for c in partitions]} rows x {dim} fp32, finite; "
          f"captions equal the sources in key order; encoder_embedding_size {dim}")


def run_preprocess(dev, workdir: Path, tag: str):
    """Phase 8: the preprocess stage at ViT-L/14.  Returns the patch_embed
    row of the kernels JSON and the sdpa_packed launches of the run."""
    from clipcap_tpu_torch.models import clip_vit
    from clipcap_tpu_torch.models.clip_vit import clip_encode_image
    from clipcap_tpu_torch.ops.attention import sdpa_packed
    from clipcap_tpu_torch.ops.patch_embed import patch_embed, patch_embed_ref
    from clipcap_tpu_torch.ops.quick_gelu import quick_gelu

    t_phase = time.perf_counter()
    raw = workdir / "raw"
    file_captions, wds_captions = write_preprocess_inputs(raw)
    print(f"preprocess: wrote {PRE_FILES} + {PRE_WDS} seeded noise JPEGs in "
          f"{time.perf_counter() - t_phase:.1f} s")
    built = []
    batches = 2 * math.ceil(PRE_FILES / 2 / PRE_BATCH) + math.ceil(PRE_WDS / PRE_BATCH)
    layers = clip_vit.get_clip_config(PRE_VARIANT).vision.layers
    blocks = layers - 1    # sdpa_packed's: the last block runs the class token alone

    # The main path: every count set to 0 just before, read just after.
    patch_embed.launches = sdpa_packed.launches = quick_gelu.launches = 0
    preprocess_cli(dev, "files, 2 partitions",
                   ["--input-dataset", str(raw / "files"), "--output-folder",
                    str(workdir / "out_files"), "--output-partition-count", "2"],
                   built, PRE_FILES)
    preprocess_cli(dev, "webdataset",
                   ["--input-dataset", str(raw / "wds" / "shard-{0000..0000}.tar"),
                    "--input-format", "webdataset", "--wds-caption-key", "json/caption",
                    "--output-folder", str(workdir / "out_wds")],
                   built, PRE_WDS)
    launches = {"patch_embed": patch_embed.launches, "sdpa_packed": sdpa_packed.launches,
                "quick_gelu": quick_gelu.launches}
    print(f"preprocess: {batches} batches of <= {PRE_BATCH}; launches {launches} "
          f"(quick_gelu gate: {layers} blocks x {batches} batches)")
    if launches["patch_embed"] < batches or launches["sdpa_packed"] < blocks * batches \
            or launches["quick_gelu"] != layers * batches:
        raise AssertionError(f"preprocess: launches {launches} for {batches} batches")
    check_dataset(workdir / "out_files", [file_captions[0::2], file_captions[1::2]],
                  "files, 2 partitions")
    check_dataset(workdir / "out_wds", [wds_captions], "webdataset")

    # The same images through the same encoder with the patch embedding
    # patched to its twin (here only; the port has no switch).
    encoder, transform = built[0]
    keys = sorted(f"img_{i:05d}" for i in range(PRE_FILES))[0::2][:PRE_BATCH]
    batch = np.stack([transform(str(raw / "files" / f"{k}.jpg")) for k in keys])
    written = np.load(workdir / "out_files" / "embeddings" / "embeds_0.npy")[:PRE_BATCH]
    n0 = patch_embed.launches
    with mock.patch.object(clip_vit, "patch_embed", patch_embed_ref):
        plain = encoder(batch)
    if patch_embed.launches != n0:
        raise AssertionError("the twin route launched the patch_embed kernel")
    cos = (plain * written).sum(-1) / (np.linalg.norm(plain, axis=-1)
                                       * np.linalg.norm(written, axis=-1))
    print(f"preprocess: {PRE_BATCH} images, written rows (kernel) vs the twin route: min cosine "
          f"{cos.min():.6f} (gate 0.999), max|d| {np.abs(plain - written).max():.4g} at "
          f"max|ref| {np.abs(plain).max():.4g}")
    if not cos.min() >= 0.999:
        raise AssertionError(f"preprocess: cosine {cos.min()} under 0.999")

    # ViT-L/14 b256 embeds/s on device tensors, kernel and twin.
    visual = copy.deepcopy(encoder.model.visual).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(7)
    side = encoder.config.vision.image_size
    inputs = [torch.randint(0, 256, (PRE_BATCH, side, side, 3), generator=g, device=dev,
                            dtype=torch.uint8) for _ in range(3)]

    @torch.no_grad()
    def embed(x):
        return clip_encode_image(visual, x, dtype=torch.bfloat16)

    rates = {}
    for route in ("kernel", "twin", "kernel"):
        patch = (mock.patch.object(clip_vit, "patch_embed", patch_embed_ref) if route == "twin"
                 else contextlib.nullcontext())
        with patch:
            per_trial = rate(embed, inputs, PRE_BATCH)
        rates.setdefault(route, []).extend(per_trial)
        print(f"time [{tag}] ViT-L/14 b{PRE_BATCH} bf16 uint8, patch embedding by the {route}: "
              f"embeds/s per trial {per_trial}; median {statistics.median(per_trial):.1f}")
    med = statistics.median(rates["kernel"])
    profile(embed, inputs[0], PRE_BATCH * 1e3 / med, f"ViT-L/14 b{PRE_BATCH}", tag)
    clip = encoder.model                              # fp32, for phase 10c
    del visual, inputs, built, encoder
    times = time_patch_embed(dev, tag)
    print(f"preprocess: phase took {time.perf_counter() - t_phase:.1f} s")
    return ({"launches": launches["patch_embed"], **times}, launches["sdpa_packed"], rates,
            clip, file_captions)


EVAL_IMAGES, EVAL_BATCH, EVAL_METRICS = 64, 32, ("Bleu_1", "Bleu_4", "METEOR", "ROUGE_L",
                                                   "CIDEr", "SPICE", "SPIDEr")
SWITCHES_ON = {"CLIPCAP_CACHE_TILE_MAJOR": "1", "CLIPCAP_FLASH_MANUAL": "1"}
SWITCHES_OFF = {"CLIPCAP_CACHE_TILE_MAJOR": "0", "CLIPCAP_FLASH_MANUAL": "0"}


def write_eval_inputs(root: Path):
    """Phase 9a: 64 seeded noise JPEGs (half 256x320, half 320x256) and a
    reference CSV with five seeded captions each."""
    import pandas as pd
    from PIL import Image

    rng = np.random.default_rng(9)
    images = root / "images"
    images.mkdir(parents=True)
    words = "a man woman dog cat red blue small sits stands near on the street park".split()
    rows = []
    for i in range(EVAL_IMAGES):
        shape = (256, 320, 3) if i % 2 else (320, 256, 3)
        name = f"eval_{i:03d}.jpg"
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(images / name,
                                                                          quality=90)
        rows.append({"file_name": name, **{f"ref_{j}": " ".join(rng.choice(words, 6))
                                           for j in range(1, 6)}})
    pd.DataFrame(rows).to_csv(root / "refs.csv", index=False)
    return images, root / "refs.csv"


def run_eval_phase(dev, slice_dir: Path, workdir: Path, tag: str):
    """Phase 9: ``clipcap_tpu_torch.eval`` through ``base.run_eval(argv)``
    on the phase-3 checkpoint (ViT-B/32 + 8-layer mapper + GPT-2 124M), 64
    images, batches of 32 x 5 candidates, bf16, with the tile-major cache
    and the manual-pipeline kernel switched on.  Gates: exit 0, one
    prediction per image, every metric present and finite, the manual
    kernel and ``sdpa_packed`` launched; then two fp32 ``--top-k 1``
    generations, the switches on and off, give the same predictions.
    Information: generation samples/s and scoring seconds.  Returns the
    manual kernel's launches in the main run."""
    from clipcap_tpu_torch.eval import base
    from clipcap_tpu_torch.inference import engine
    from clipcap_tpu_torch.ops.attention import sdpa_packed
    from clipcap_tpu_torch.ops.flash_decode import flash_decode

    t_phase = time.perf_counter()
    images, csv = write_eval_inputs(workdir)
    argv = ["--model-path", str(slice_dir / "model.npz"), "--config-path",
            str(slice_dir / "config.yaml"), "--sample-path", str(images), "--reference-csv",
            str(csv), "--csv-filename-column", "file_name", "--csv-reference-caption-columns",
            "ref_{1..5}", "--eval-batch-size", str(EVAL_BATCH), "--number-to-generate", "5",
            "--allow-fallback-tokenizer", "--device", str(dev)]
    seconds = {}

    def timed(fn, key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync(dev)
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
            return out
        return call

    def last_call(fn, key):
        def call(*args, **kw):
            calls[key] = (args, kw)
            return fn(*args, **kw)
        return call

    calls = {}
    # The main path: every count set to 0 just before, read just after.
    flash_decode.launches = flash_decode.manual_launches = sdpa_packed.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with warnings.catch_warnings(), contextlib.redirect_stdout(_Tee(sys.stdout, log)), \
            mock.patch.dict(os.environ, SWITCHES_ON), \
            mock.patch.object(base, "generate_predictions",
                              timed(base.generate_predictions, "generate")), \
            mock.patch.object(base, "evaluate_metrics_from_lists",
                              timed(base.evaluate_metrics_from_lists, "score")), \
            mock.patch.object(engine, "decode",
                              timed(last_call(engine.decode, "decode"), "decode")):
        warnings.simplefilter("ignore")               # seeded CLIP, byte tokenizer offline
        rc = base.run_eval(argv + ["--fp-precision", "16", "--save-predictions",
                                   str(workdir / "preds.json"), "--save-file",
                                   str(workdir / "scores.json")])
    sync(dev)
    total = time.perf_counter() - t0
    launches = {"flash_decode": flash_decode.launches,
                "flash_decode_manual": flash_decode.manual_launches,
                "sdpa_packed": sdpa_packed.launches}
    preds = json.loads((workdir / "preds.json").read_text())
    scores = json.loads((workdir / "scores.json").read_text())
    gen, dec = seconds.get("generate", 0.0), seconds.get("decode", 0.0)
    print(f"eval: exit {rc} in {total:.1f} s; generation {gen:.2f} s for {EVAL_IMAGES} images x 5 "
          f"candidates ({EVAL_IMAGES / max(gen, 1e-9):.1f} samples/s, model and encoder build "
          f"included), of which the decode calls {dec:.2f} s ({EVAL_IMAGES / max(dec, 1e-9):.1f} "
          f"samples/s); scoring {seconds.get('score', 0.0):.2f} s; launches {launches}")
    from clipcap_tpu_torch import native

    print(f"eval: scores {({k: scores.get(k) for k in EVAL_METRICS})}; METEOR and PTB "
          f"tokenizer {'native C++ core' if native._lib is not None else 'Python scorers'}")
    if rc != 0 or sorted(preds) != sorted(p.name for p in images.iterdir()):
        raise AssertionError(f"eval: exit {rc}, {len(preds)} predictions")
    if not all(isinstance(v, str) for v in preds.values()):
        raise AssertionError("eval: a prediction is not a caption")
    bad = [k for k in EVAL_METRICS if not isinstance(scores.get(k), (int, float))
           or not math.isfinite(scores[k])]
    if bad:
        raise AssertionError(f"eval: metrics missing or not finite: {bad}")
    if launches["flash_decode_manual"] == 0 or launches["sdpa_packed"] == 0:
        raise AssertionError(f"eval: launches {launches}")

    # One generation batch's decode again (the last batch's arguments),
    # unprofiled for its time, then under the profiler; and row 4 alone at
    # the shape this decode gives it.
    args, kw = calls["decode"]

    def decode_batch(_):
        with mock.patch.dict(os.environ, SWITCHES_ON):
            engine.decode(*args, **kw)
        sync(dev)

    t0 = time.perf_counter()
    decode_batch(None)
    batch_ms = (time.perf_counter() - t0) * 1e3
    R = args[1].shape[0]
    profile(decode_batch, None, batch_ms, f"eval generation batch: nucleus decode R={R}, "
            f"{N_NEW} new tokens, switches on", tag)
    del args, kw, calls
    eval_row = time_manual_eval_shape(dev, R, tag)

    # fp32 top-k 1: the argmax path, so the switches must not move a token.
    runs = {}
    for label, env in (("on", SWITCHES_ON), ("off", SWITCHES_OFF)):
        n0 = flash_decode.manual_launches
        with warnings.catch_warnings(), contextlib.redirect_stdout(io.StringIO()), \
                mock.patch.dict(os.environ, env):
            warnings.simplefilter("ignore")
            runs[label] = base.generate_predictions(base.build_parser().parse_args(
                argv + ["--fp-precision", "32", "--top-k", "1"]))
        print(f"eval: fp32 top-k 1 switches {label}: {len(runs[label])} predictions, "
              f"{flash_decode.manual_launches - n0} manual-pipeline launches")
    same = sum(runs["on"][k] == runs["off"].get(k) for k in runs["on"])
    print(f"eval: fp32 top-k 1 predictions equal with the switches on and off: {same} of "
          f"{len(runs['on'])}")
    if runs["on"] != runs["off"] or len(runs["on"]) != EVAL_IMAGES:
        raise AssertionError("eval: fp32 top-k 1 predictions differ between the switches")
    print(f"eval: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches["flash_decode_manual"], eval_row


def time_manual_eval_shape(dev, R: int, tag: str):
    """Phase 9b: the manual-pipeline kernel (S = 2) at the eval decode's
    shape: R rows of K = 1, GPT-2 124M's 12 heads, one 80-slot tile-major
    tile, the causal mask at position 40 (u_valid 41), bf16; beside the
    auto kernel, the twin and SDPA, with the bound."""
    import torch.nn.functional as F

    from clipcap_tpu_torch.models.gpt2 import causal_bias
    from clipcap_tpu_torch.ops.flash_decode import flash_decode, flash_decode_ref

    g = torch.Generator(device=dev).manual_seed(10)
    bf, H, U, pos = torch.bfloat16, 12, 80, 40
    q = torch.randn(R, H, 1, 64, generator=g, device=dev).to(bf)
    kv = torch.randn(R, H, U, 128, generator=g, device=dev).to(bf)
    kv5 = tile_major(kv, U)
    mask = causal_bias(1, U, pos, device=dev)[:, 0]
    u = pos + 1
    t = {**timed(lambda: flash_decode(q, kv5, mask, u, manual=True)),
         **timed(lambda: flash_decode(q, kv5, mask, u, manual=False), "auto_"),
         **timed(lambda: flash_decode_ref(q, kv, mask, u), "plain_"),
         **timed(lambda: F.scaled_dot_product_attention(
             q, kv[:, :, :u, :64], kv[:, :, :u, 64:], attn_mask=mask[:, None, :, :u].to(bf)),
             "library_"),
         **decode_bound(q, [(R * u, 256, u)], bf)}
    print(f"time [{tag}] flash_decode_manual eval shape R={R} H={H} K=1 u=80 tile-major "
          f"u_valid={u} bf16 S=2: {t}")
    return t


# ---------------------------------------------------------------------------
# Phase 10: finetune + export, int8 weights (w8a16 GPT-2, w8a8 ViT)
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def run_finetune_export(dev, root: Path, workdir: Path, embedding):
    """Phase 10a: ``clipcap_tpu_torch.finetune.start_finetuning`` (argv as
    the CLI gets it, without ``--train-language-model``) on phase 6's
    dataset, then ``utils.export_checkpoint.export_params`` on its final
    checkpoint.  Gates (beside ``train_cli``'s: finite losses, launches,
    files, the checkpoint captions): GPT-2's weights moved from the ones
    training started from, and the params-only file loads on the card and
    captions an embedding.  Returns the fused-AdamW launches of the run."""
    from clipcap_tpu_torch import generate_beam, load
    from clipcap_tpu_torch.convert import gpt2_params
    from clipcap_tpu_torch.finetune import start_finetuning
    from clipcap_tpu_torch.models.hf_import import load_gpt2
    from clipcap_tpu_torch.train.checkpoint import restore_params
    from clipcap_tpu_torch.utils.export_checkpoint import export_params

    t0 = time.perf_counter()
    out, exported = workdir / "finetune", workdir / "finetune_export.npz"
    launches = train_cli(dev, root, out, "10a finetune", [], embedding, start=start_finetuning)
    export_params(str(out / "clipcap_final.npz"), str(exported))
    keys = list(np.load(exported).keys())
    if not keys or any(k == "step" or k.startswith(("params::", "opt_state::")) for k in keys):
        raise AssertionError(f"finetune: the export kept train-state keys {keys[:5]}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")               # seeded GPT-2: no weights offline
        start = dict(_leaves(gpt2_params(load_gpt2("gpt2"))))
    tuned = dict(_leaves(restore_params(str(exported))["lm"]))
    moved = {k: float(np.abs(tuned[k] - start[k]).max()) for k in start}
    if tuned.keys() != start.keys() or not max(moved.values()) > 0:
        raise AssertionError(f"finetune: GPT-2 did not train ({moved})")
    model, tokenizer = load(str(exported), str(out / "clipcap_config.yaml"), device=dev)
    prefix = model.transformer_mapper(embedding[None])
    caption = generate_beam(model, tokenizer, prefix, number_to_generate=1, beam_size=K)
    if len(caption) != 1 or not isinstance(caption[0], str) or not torch.isfinite(prefix).all():
        raise AssertionError("finetune: the exported checkpoint did not caption")
    print(f"finetune: {len(keys)} params-only arrays exported; GPT-2 moved in "
          f"{sum(v > 0 for v in moved.values())} of {len(moved)} tensors (max|d| "
          f"{max(moved.values()):.3g}); the export loaded on {dev} and captioned "
          f"{caption[0]!r}; {time.perf_counter() - t0:.1f} s")
    return launches


def int8_weight_gates(dev, slice_dir: Path, eval_dir: Path):
    """Phase 10b, gates: a seeded GPT-2 XL + mapper (phase 7's weights) in
    fp32, its LM quantised from the fp32 weights.  Beam 5, R = 4, 67 new
    tokens: the tokens through the kernels equal those through the twins
    (decode attention patched to the twin, here only), and the kernel run
    launches ``flash_decode``; one prefill's logits on the card within 1e-3
    (max|d| over max|ref|) of the same quantised model's on the CPU.  Then
    ``--int8-weights`` through the inference CLI's function and through
    eval's generation, each on phase 3's GPT-2 124M checkpoint with the
    counts set to 0 just before.  Returns the int8 model (floats in bf16)
    and phase 7's first b96 bf16 prefix, for the timings, and the
    launches."""
    from clipcap_tpu_torch.eval import base
    from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
    from clipcap_tpu_torch.models import gpt2
    from clipcap_tpu_torch.ops.attention import sdpa_packed
    from clipcap_tpu_torch.ops.flash_decode import flash_decode, flash_decode_ref
    from clipcap_tpu_torch.ops.quant import quantize_gpt2_int8

    t0 = time.perf_counter()
    model = seeded_xl(dev)
    qlm = quantize_gpt2_int8(model.language_model)
    g = torch.Generator(device=dev).manual_seed(6)
    prefix = model.transformer_mapper(torch.randn(4, 768, generator=g, device=dev))
    bp = BeamParams(beam_size=K, max_new_tokens=N_NEW, stop_token=50256)
    n0 = flash_decode.launches
    kern = beam_search_batched(qlm, prefix, bp, dtype=torch.float32)
    launches = {"xl_fp32_r4": flash_decode.launches - n0}
    with mock.patch.object(gpt2, "flash_decode", flash_decode_ref):
        twin = beam_search_batched(qlm, prefix, bp, dtype=torch.float32)
    if launches["xl_fp32_r4"] == 0 or flash_decode.launches != n0 + launches["xl_fp32_r4"]:
        raise AssertionError(f"int8 weights: kernel run {launches}, the twin run launched")
    print(f"int8 weights: fp32 XL R=4 beam 5, int8-weight tokens kernels "
          f"({launches['xl_fp32_r4']} launches) vs twins: {agreement(kern, twin)}")
    if not torch.equal(kern.tokens, twin.tokens):
        raise AssertionError("int8 weights: fp32 tokens differ between kernels and twins")
    logits, _ = gpt2.gpt2_apply(qlm, inputs_embeds=prefix[:1])
    plain, _ = gpt2.gpt2_apply(model.language_model, inputs_embeds=prefix[:1])
    cpu_lm = copy.deepcopy(qlm).cpu()
    want, _ = gpt2.gpt2_apply(cpu_lm, inputs_embeds=prefix[:1].cpu())
    rel = ((logits.cpu() - want).abs().max() / want.abs().max()).item()
    moved = ((logits - plain).abs().max() / plain.abs().max()).item()
    print(f"int8 weights: XL prefill logits [1, {P}, 50257] card vs CPU, same int8 model: "
          f"max|d|/max|ref| {rel:.3g} (gate 1e-3); int8 vs fp32 weights (information) "
          f"{moved:.3g}")
    if not rel <= 1e-3:
        raise AssertionError(f"int8 weights: card and CPU logits differ by {rel}")
    g = torch.Generator(device=dev).manual_seed(5)     # phase 7's first b96 prefix
    x = model.transformer_mapper.to(torch.bfloat16)(
        torch.randn(XL_BATCH, 768, generator=g, device=dev), dtype=torch.bfloat16)
    del cpu_lm, want, logits, plain, model
    gc.collect()
    torch.cuda.empty_cache()

    flash_decode.launches = 0
    int8_cli(slice_dir, dev, "--int8-weights")
    launches["cli"] = flash_decode.launches
    argv = ["--model-path", str(slice_dir / "model.npz"), "--config-path",
            str(slice_dir / "config.yaml"), "--sample-path", str(eval_dir / "images"),
            "--reference-csv", str(eval_dir / "refs.csv"), "--eval-batch-size",
            str(EVAL_BATCH), "--number-to-generate", "5", "--allow-fallback-tokenizer",
            "--device", str(dev), "--fp-precision", "16", "--int8-weights"]
    flash_decode.launches = sdpa_packed.launches = 0
    with warnings.catch_warnings(), contextlib.redirect_stdout(io.StringIO()):
        warnings.simplefilter("ignore")
        preds = base.generate_predictions(base.build_parser().parse_args(argv))
    sync(dev)
    launches.update(eval=flash_decode.launches, eval_sdpa_packed=sdpa_packed.launches)
    print(f"int8 weights: eval generation --int8-weights on {len(preds)} images; launches "
          f"{launches}; {time.perf_counter() - t0:.1f} s for the gates")
    if len(preds) != EVAL_IMAGES or not all(isinstance(v, str) for v in preds.values()):
        raise AssertionError(f"int8 weights: eval gave {len(preds)} predictions")
    if min(launches.values()) == 0:
        raise AssertionError(f"int8 weights: launches {launches}")
    return qlm.to(torch.bfloat16), x, launches


def int8_weight_timings(qlm, x, dev, bf16_weights, tag: str):
    """Phase 10b, information: beam 5 at b96 bf16, C = 0, bf16 and int8 KV
    cache, with int8 weights beside phase 7's bf16 weights (same run):
    captions/s and peak device memory, a ``torch.profiler`` breakdown of
    one int8-cache batch cut to 8 new tokens (phase 7 profiles the same
    with bf16 weights), and the eager widening of one forward's 192 int8
    weights to bf16 (CUDA events), the copy ``linear`` writes at each
    projection."""
    from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched

    t_start = time.perf_counter()
    for int8_kv in (False, True):
        bp = BeamParams(beam_size=K, max_new_tokens=N_NEW, stop_token=50256, int8_kv=int8_kv)

        def work(prefix, bp=bp):
            return beam_search_batched(qlm, prefix, bp, dtype=torch.bfloat16)

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cps = rate(work, [x], XL_BATCH, trials=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        base_cps, base_peak = bf16_weights[int8_kv, 0]
        print(f"time [{tag}] beam-5 GPT-2 XL b{XL_BATCH} bf16, int8 weights, int8_kv={int8_kv} "
              f"C=0: captions/s per trial {cps}; median {statistics.median(cps):.2f} (bf16 "
              f"weights, phase 7: {base_cps:.2f}); peak device memory {peak:.2f} GiB (bf16 "
              f"weights: {base_peak:.2f})")
        if int8_kv:
            profile_xl_steps(qlm, x, f"beam-5 GPT-2 XL b{XL_BATCH} int8 weights, int8 C=0", tag)
    weights = [w for layer in qlm.h for w in (layer.attn.c_attn.weight, layer.attn.c_proj.weight,
                                               layer.mlp.c_fc.weight, layer.mlp.c_proj.weight)]
    widen_ms = cuda_ms(lambda: [w.in_out().to(torch.bfloat16) for w in weights], iters=5)
    n = sum(w.q.numel() for w in weights)
    print(f"time [{tag}] eager int8 -> bf16 widening of the {len(weights)} XL block weights "
          f"({n / 1e9:.3f} G parameters, {3 * n / 1e9:.2f} GB moved): {widen_ms:.3f} ms per "
          f"forward, x{N_NEW + 1} forwards = {widen_ms * (N_NEW + 1):.1f} ms a batch "
          f"({3 * n / widen_ms / 1e6:.0f} GB/s)")
    print(f"int8 weights: timings took {time.perf_counter() - t_start:.1f} s")


def run_w8a8(dev, clip, raw: Path, workdir: Path, file_captions, bf16_rates, tag: str):
    """Phase 10c: the w8a8 ViT-L/14 (phase 8's seeded weights), quantised
    from the fp32 weights.  Gates: the fp32 float tower on the card within
    1e-3 (‖d‖ / ‖ref‖) of the port's CPU forward of the same image; the
    fp32 w8a8 forward on the card at B = 1, 17 and 64 in lockstep with the
    CPU, each ``int8_linear`` call also run on the CPU on the same inputs
    (the first image's rows) within 1e-5 of max|ref|.  As with phase 7's
    int8 cache, the whole w8a8 forward cannot be the gate: rounding to int8
    is not continuous, a summation-order difference of ~1e-7 flips the odd
    quantised value, and 24 layers of seeded weights carry that to ~1e-2
    (printed beside the card's own B = 1 against B = 17).  The int8
    ``CLIPEncoder.similarity`` runs on the card at B = 1 and equals
    ``clip_similarity(int8_acts=True)`` on the quantised model; the
    preprocess entry point with ``--int8-encoder true`` on one 256-image
    partition (counts set to 0 just before) exits 0, writes finite
    [256, 768] rows and launches ``patch_embed`` and ``sdpa_packed``.
    Information: ViT-L/14 w8a8 b64 embeds/s (bench.py's shape) beside bf16
    b64 and phase 8's bf16 b256, the four projections' ms against the bf16
    ``linear``, the cosine of w8a8 against the float tower at fp32.
    Returns the launches."""
    from clipcap_tpu_torch.encoders.clip import CLIPEncoder
    from clipcap_tpu_torch.models import clip_vit
    from clipcap_tpu_torch.models.clip_vit import clip_encode_image, clip_similarity
    from clipcap_tpu_torch.ops.attention import sdpa_packed
    from clipcap_tpu_torch.ops.layers import Int8Weight, linear
    from clipcap_tpu_torch.ops.patch_embed import patch_embed
    from clipcap_tpu_torch.ops.quant import int8_linear, quantize_clip_visual_int8, quantize_rows
    from clipcap_tpu_torch.utils.clip_tokenizer import tokenize

    t0 = time.perf_counter()
    qclip = quantize_clip_visual_int8(clip)
    side = clip.config.vision.image_size
    g = torch.Generator(device=dev).manual_seed(10)
    images = torch.randint(0, 256, (64, side, side, 3), generator=g, device=dev,
                           dtype=torch.uint8)

    def rel(a, b):
        return ((a.cpu() - b.cpu()).norm() / b.cpu().norm()).item()

    def lockstep(diffs):
        """``int8_linear`` on the card, and on the CPU for the first image's
        rows of the same inputs (the product is row by row)."""
        def call(x, w, b=None):
            got = int8_linear(x, w, b)
            want = int8_linear(x[:1].cpu(), Int8Weight(w.q.cpu(), w.s.cpu(), w.out_in),
                               None if b is None else b.cpu())
            diffs.append(((got[:1].cpu() - want).abs().max() / want.abs().max()).item())
            return got
        return call

    with torch.no_grad():
        cpu_visual = copy.deepcopy(qclip.visual).cpu()
        want = clip_encode_image(cpu_visual, images[:1].cpu(), int8_acts=True)[0]
        cpu_visual = copy.deepcopy(clip.visual).cpu()
        plain_cpu = clip_encode_image(cpu_visual, images[:1].cpu())[0]
        del cpu_visual
        plain = clip_encode_image(clip.visual, images, dtype=torch.float32)
        float_rel = rel(plain[0], plain_cpu)
        print(f"w8a8: ViT-L/14 fp32 float tower on the card vs the CPU, first image: "
              f"|d|/|ref| {float_rel:.3g} (gate 1e-3)")
        if not float_rel <= 1e-3:
            raise AssertionError(f"w8a8: the float tower differs from the CPU's by {float_rel}")
        firsts, lock = {}, {}
        for B in (1, 17, 64):
            diffs = []
            with mock.patch.object(clip_vit, "int8_linear", lockstep(diffs)):
                got = clip_encode_image(qclip.visual, images[:B], int8_acts=True)
            if got.shape != (B, PRE_DIM) or not torch.isfinite(got).all():
                raise AssertionError(f"w8a8: B={B} gave {tuple(got.shape)}")
            firsts[B], lock[B] = got[0], (len(diffs), max(diffs))
        print(f"w8a8: ViT-L/14 fp32 w8a8 forward on the card at B = 1, 17, 64 in lockstep with "
              f"the CPU: (int8_linear calls, max|d|/max|ref| of a call) {lock} (gate 1e-5)")
        if not max(d for _, d in lock.values()) <= 1e-5:
            raise AssertionError(f"w8a8: int8_linear on the card and the CPU differ: {lock}")
        print(f"w8a8 (information): first image, whole forward, |d|/|ref| card vs CPU by batch "
              f"{ {B: round(rel(x, want), 5) for B, x in firsts.items()} }; card B=1 vs B=17 "
              f"{rel(firsts[1], firsts[17]):.3g} (int8 rounding is not continuous: "
              f"summation-order differences flip quantised values and 24 layers amplify them)")
        cos = torch.nn.functional.cosine_similarity(got, plain)
        print(f"w8a8: cosine of the w8a8 tower against the float tower, fp32, b64 "
              f"(information): min {cos.min().item():.6f}, mean {cos.mean().item():.6f}")

        encoder = CLIPEncoder(clip, clip.config, int8=True)
        captions = ["a dog on a bench", "a red car by the sea", "two cats asleep"]
        sims = encoder.similarity(images[0].cpu().numpy(), captions)
        ref, _ = clip_similarity(qclip, images[:1], torch.as_tensor(tokenize(captions),
                                                                    device=dev), int8_acts=True)
        d = np.abs(sims - ref[0].cpu().numpy()).max()
        print(f"w8a8: CLIPEncoder(int8=True).similarity at B=1 on the card: "
              f"{np.round(sims, 4).tolist()}; vs clip_similarity(int8_acts=True) max|d| "
              f"{d:.3g} (tol 1e-4)")
        if sims.shape != (3,) or not np.isfinite(sims).all() or not d <= 1e-4:
            raise AssertionError(f"w8a8: similarity {sims} against {ref}")
        del encoder, ref

    # The preprocess entry point with --int8-encoder on one partition.
    part = raw / "int8"
    part.mkdir()
    keys = [f"img_{i:05d}" for i in range(PRE_BATCH)]
    for key in keys:
        for ext in (".jpg", ".txt"):
            shutil.copy(raw / "files" / f"{key}{ext}", part / f"{key}{ext}")
    built = []
    patch_embed.launches = sdpa_packed.launches = 0
    preprocess_cli(dev, "int8 encoder", ["--input-dataset", str(part), "--output-folder",
                                         str(workdir / "out_int8"), "--int8-encoder", "true"],
                   built, PRE_BATCH)
    launches = {"patch_embed": patch_embed.launches, "sdpa_packed": sdpa_packed.launches}
    print(f"w8a8: preprocess --int8-encoder true, one batch of {PRE_BATCH}; launches {launches}")
    blocks = clip.config.vision.layers - 1
    if launches["patch_embed"] < 1 or launches["sdpa_packed"] < blocks or not built[0][0].int8:
        raise AssertionError(f"w8a8 preprocess: launches {launches}")
    check_dataset(workdir / "out_int8", [file_captions[:PRE_BATCH]], "int8 encoder")
    del built

    # Information: embeds/s, the projections, on the same run.
    bf16_visual = copy.deepcopy(clip.visual).to(torch.bfloat16)
    inputs = [torch.randint(0, 256, (64, side, side, 3), generator=g, device=dev,
                            dtype=torch.uint8) for _ in range(3)]
    for label, visual, int8_acts in (("w8a8", qclip.visual, True),
                                     ("bf16", bf16_visual, False)):
        @torch.no_grad()
        def embed(x, visual=visual, int8_acts=int8_acts):
            return clip_encode_image(visual, x, dtype=torch.bfloat16, int8_acts=int8_acts)

        per_trial = rate(embed, inputs, 64)
        print(f"time [{tag}] ViT-L/14 b64 bf16 uint8 {label}: embeds/s per trial {per_trial}; "
              f"median {statistics.median(per_trial):.1f} (bf16 b{PRE_BATCH}, phase 8: median "
              f"{statistics.median(bf16_rates):.1f})")
        if label == "w8a8":
            profile(embed, inputs[0], 64e3 / statistics.median(per_trial),
                    "ViT-L/14 b64 w8a8", tag)
    block = qclip.visual.transformer.resblocks[0]
    fblock = bf16_visual.transformer.resblocks[0]
    M = 64 * (clip.config.vision.n_patches + 1)
    for name, w, b, fw, fb in (
            ("in_proj", block.attn.in_proj_weight, block.attn.in_proj_bias,
             fblock.attn.in_proj_weight, fblock.attn.in_proj_bias),
            ("out_proj", block.attn.out_proj.weight, block.attn.out_proj.bias,
             fblock.attn.out_proj.weight, fblock.attn.out_proj.bias),
            ("c_fc", block.mlp.c_fc.weight, block.mlp.c_fc.bias,
             fblock.mlp.c_fc.weight, fblock.mlp.c_fc.bias),
            ("c_proj", block.mlp.c_proj.weight, block.mlp.c_proj.bias,
             fblock.mlp.c_proj.weight, fblock.mlp.c_proj.bias)):
        x = torch.randn(M, w.q.shape[1], generator=g, device=dev).to(torch.bfloat16)
        q, _ = quantize_rows(x)
        ms = {"int8_linear": cuda_ms(lambda: int8_linear(x, w, b)),
              "_int_mm": cuda_ms(lambda: torch._int_mm(q, w.in_out())),
              "quantize_rows": cuda_ms(lambda: quantize_rows(x)),
              "bf16 linear": cuda_ms(lambda: linear(x, fw.t(), fb))}
        N, Kd = w.q.shape
        print(f"time [{tag}] w8a8 projection {name} M={M} K={Kd} N={N}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f"; _int_mm {2 * M * Kd * N / ms['_int_mm'] / 1e9:.1f} TOP/s, bf16 linear "
              f"{2 * M * Kd * N / ms['bf16 linear'] / 1e9:.1f} TFLOP/s")
    del bf16_visual, inputs, qclip
    print(f"w8a8: phase took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 11: audio captioning (CLAP: HTSAT-tiny, log-mel, RoBERTa rerank)
# ---------------------------------------------------------------------------

AUDIO_CLIPS, AUDIO_FUSION, AUDIO_BATCH, AUDIO_DIM, AUDIO_EVAL = 256, 8, 64, 512, 32
AUDIO_CHECK, RERANK_SIZES = 8, (5, 160)   # clips held card against CPU; captions timed
AUDIO_WORDS = ("a dog barks car passes rain falls on the roof people talk while bird sings "
               "engine hums water runs wind blows door closes loudly softly").split()


def _write_wav(path: Path, data: np.ndarray, rate: int) -> None:
    """int16 PCM WAV of ``data`` ([frames] or [frames, channels], in [-1, 1])."""
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1 if data.ndim == 1 else data.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(data, -1, 1) * 32767).astype("<i2").tobytes())


def write_audio_inputs(root: Path):
    """Phase 11a: 256 seeded WAV clips with ``.txt`` captions, alternately
    10 s at 44.1 kHz stereo (AudioCaps-like: resampled and mixed down on
    the host) and 20 s at 48 kHz mono (Clotho-like: cut to 10 s in plain
    mode), each a seeded tone under seeded noise; and 8 clips of 25 s at
    48 kHz for the fusion check.  Returns the captions in key order."""
    rng = np.random.default_rng(11)

    def clip(rate, seconds):
        t = np.arange(rate * seconds, dtype=np.float32) / rate
        tone = np.sin(2 * np.pi * rng.uniform(100, 4000) * t, dtype=np.float32)
        return 0.25 * tone + 0.05 * rng.standard_normal(t.shape, dtype=np.float32)

    clips, fusion = root / "clips", root / "fusion"
    clips.mkdir(parents=True)
    fusion.mkdir()
    captions = []
    for i in range(AUDIO_CLIPS):
        if i % 2 == 0:
            x = clip(44100, 10)
            _write_wav(clips / f"clip_{i:05d}.wav", np.stack([x, 0.8 * x], axis=1), 44100)
        else:
            _write_wav(clips / f"clip_{i:05d}.wav", clip(48000, 20), 48000)
        captions.append(" ".join(rng.choice(AUDIO_WORDS, 6)))
        (clips / f"clip_{i:05d}.txt").write_text(captions[-1])
    for i in range(AUDIO_FUSION):
        _write_wav(fusion / f"long_{i:02d}.wav", clip(48000, 25), 48000)
    return captions


def write_clap_checkpoints(root: Path):
    """Phase 11a: seeded laion_clap-format checkpoints at full width:
    HTSAT-tiny with a RoBERTa-base text tower and the 768 → 512 → 512
    projections, and the fusion variant's audio half (``mel_conv2d``, AFF)."""
    from clipcap_tpu_torch.convert import clap_text_from_params, htsat_from_params
    from clipcap_tpu_torch.models.htsat import CLAP_PRESETS, init_htsat
    from clipcap_tpu_torch.models.roberta import RobertaConfig, init_roberta

    cfg, rcfg = CLAP_PRESETS["HTSAT-tiny"], RobertaConfig()
    rng = np.random.default_rng(12)

    def lin(n_in, n_out):
        return {"w": rng.normal(0, 0.02, (n_in, n_out)).astype(np.float32),
                "b": np.zeros(n_out, np.float32)}

    text = clap_text_from_params({"roberta": init_roberta(rcfg, seed=12),
                                  "projection": {"fc1": lin(rcfg.hidden_size, AUDIO_DIM),
                                                 "fc2": lin(AUDIO_DIM, AUDIO_DIM)}}, rcfg)
    audio = htsat_from_params(init_htsat(cfg, seed=11), cfg)
    plain = root / "clap_htsat_tiny.pt"
    torch.save({"state_dict": {**audio.state_dict(), **text.state_dict()}}, plain)
    fcfg = dataclasses.replace(cfg, enable_fusion=True)
    fused = root / "clap_htsat_tiny_fusion.pt"
    torch.save({"state_dict": htsat_from_params(init_htsat(fcfg, seed=13), fcfg).state_dict()},
               fused)
    return plain, fused


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def clap_card_vs_cpu(dev, files, label: str, checkpoint=None) -> float:
    """Phase 11a: the fp32 embeddings of ``files`` on the card against the
    port's CPU forward of the same samples (‖d‖/‖ref‖, gate 1e-3)."""
    from clipcap_tpu_torch.encoders.clap import get_clap_encoder

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        card, transform = get_clap_encoder("HTSAT-tiny", checkpoint_path=checkpoint, device=dev)
        cpu, _ = get_clap_encoder("HTSAT-tiny", checkpoint_path=checkpoint, device="cpu")
    batch = np.stack([transform(str(f)) for f in files])
    got, want = card(batch), cpu(batch)
    err = rel_err(got, want)
    print(f"audio: {label}: {len(files)} clips {tuple(batch.shape[1:])} fp32 on the card vs the "
          f"CPU: ‖d‖/‖ref‖ {err:.3g} (gate 1e-3), fusion {card.config.enable_fusion}")
    if got.shape != (len(files), AUDIO_DIM) or not np.isfinite(got).all() or not err <= 1e-3:
        raise AssertionError(f"audio: {label}: card vs CPU {err}")
    return err


def run_audio(dev, workdir: Path, tag: str) -> dict:
    """Phase 11: audio captioning at full width, weights seeded: HTSAT-tiny
    with RoBERTa-base through ``$CLIPCAP_CLAP_CHECKPOINT`` (preprocess never
    reads ``--encoder-checkpoint-path``: ROADMAP C5).  (a) preprocess of 256
    WAVs, the card against the CPU in plain and fusion mode; (b) training on
    the CLAP embeddings; (c) ``load`` + ``get_encoder_from_model`` + beam 5
    on a clip, fp32 tokens kernels = twins; (d) sampling + the rerank, card
    against the CPU; (e) the inference CLI's function on a ``.wav``; (f)
    eval on 32 clips.  Returns the launches of rows 1 and 6 on this path."""
    from argparse import ArgumentParser

    from clipcap_tpu_torch import (generate_beam, generate_nucleus_sampling,
                                   get_encoder_from_model, load)
    from clipcap_tpu_torch.encoders.clap import CLAPEncoder, get_clap_encoder
    from clipcap_tpu_torch.inference.args import add_inference_args
    from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
    from clipcap_tpu_torch.inference.demo import inference_demo
    from clipcap_tpu_torch.models import gpt2
    from clipcap_tpu_torch.models.htsat import clap_audio_embedding
    from clipcap_tpu_torch.ops.flash_decode import flash_decode, flash_decode_ref

    t_phase = time.perf_counter()
    captions = write_audio_inputs(workdir)
    plain_ckpt, fusion_ckpt = write_clap_checkpoints(workdir)
    print(f"audio: wrote {AUDIO_CLIPS} + {AUDIO_FUSION} seeded WAVs and the seeded HTSAT-tiny + "
          f"RoBERTa-base checkpoints in {time.perf_counter() - t_phase:.1f} s")
    clips = sorted((workdir / "clips").glob("*.wav"))
    launches = {}
    with mock.patch.dict(os.environ, {"CLIPCAP_CLAP_CHECKPOINT": str(plain_ckpt)}):
        # (a) preprocess: the main path's first stage.
        built, out = [], workdir / "dataset"
        preprocess_cli(dev, "CLAP, WAV files", ["--input-dataset", str(workdir / "clips"),
                                                "--output-folder", str(out),
                                                "--encoder-model-name", "clap",
                                                "--media-file-extensions", "wav"],
                       built, AUDIO_CLIPS, variant="HTSAT-tiny", batch=AUDIO_BATCH,
                       unit="clips")
        check_dataset(out, [captions], "CLAP", dim=AUDIO_DIM, variant="HTSAT-tiny")
        encoder, transform = built[0]
        if not isinstance(encoder, CLAPEncoder) or encoder.text[1].hidden_size != 768:
            raise AssertionError(f"audio: preprocess built {type(encoder).__name__}")
        clap_card_vs_cpu(dev, clips[:AUDIO_CHECK], "plain, 10 s window")
        clap_card_vs_cpu(dev, sorted((workdir / "fusion").glob("*.wav")), "fusion, 25 s clips",
                         checkpoint=str(fusion_ckpt))

        # (b) training on the CLAP embeddings.
        embedding = torch.from_numpy(np.load(out / "embeddings" / "embeds_0.npy")[0]).to(dev)
        launches["fused_adamw"] = train_cli(dev, out, workdir / "train", "CLAP embeddings, "
                                            "prefix-only", [], embedding, rows=AUDIO_CLIPS)
        ckpt = workdir / "train"
        del built, encoder

        # (c) load + the encoder of the checkpoint + beam 5 on one clip.
        model, tokenizer = load(str(ckpt / "clipcap_final.npz"),
                                str(ckpt / "clipcap_config.yaml"), device=dev)
        encoder, transform = get_encoder_from_model(model)
        if not isinstance(encoder, CLAPEncoder) or encoder.device.type != torch.device(dev).type:
            raise AssertionError(f"audio: get_encoder_from_model gave {type(encoder).__name__}")
        sample = transform(str(clips[1]))
        flash_decode.launches = 0
        prefix = model.transformer_mapper(encoder(sample[None]))
        beams = generate_beam(model, tokenizer, prefix, number_to_generate=5, beam_size=K)
        sync(dev)
        launches["beam"] = flash_decode.launches
        bp = BeamParams(beam_size=K, max_new_tokens=N_NEW, stop_token=tokenizer.eos_token_id)
        kern = beam_search_batched(model.language_model, prefix.float(), bp, dtype=torch.float32)
        n1 = flash_decode.launches
        with mock.patch.object(gpt2, "flash_decode", flash_decode_ref):
            twin = beam_search_batched(model.language_model, prefix.float(), bp,
                                       dtype=torch.float32)
        if flash_decode.launches != n1 or not torch.equal(kern.tokens, twin.tokens):
            raise AssertionError("audio: fp32 beam-5 tokens differ between kernels and twins")
        print(f"audio: beam 5 on {clips[1].name}: {len(beams)} captions, best {beams[0]!r}; "
              f"fp32 tokens kernels == twins ({kern.tokens.numel()} tokens)")

        # (d) sampling + the CLAP rerank, the card against the CPU.
        flash_decode.launches = 0
        candidates = generate_nucleus_sampling(model, tokenizer, prefix, number_to_generate=5,
                                               top_p=0.9)
        # The seeded captioner's samples may repeat, so three captions of
        # other lengths join them.
        candidates += ["a dog barks twice", "rain falls on the roof of a car",
                       "people talk while a bird sings and an engine hums in the distance"]
        sims = encoder.similarity(sample, candidates)
        sync(dev)
        launches["sampling"] = flash_decode.launches
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cpu_encoder, _ = get_clap_encoder("HTSAT-tiny", device="cpu")
        cpu_sims = cpu_encoder.similarity(sample, candidates)
        d = float(np.abs(sims - cpu_sims).max())
        print(f"audio: rerank of 5 sampled + 3 fixed captions: sims "
              f"{np.round(sims, 4).tolist()}; card vs CPU max|d| {d:.3g} (gate 1e-4)")
        if sims.shape != (8,) or not np.isfinite(sims).all() or not d <= 1e-4:
            raise AssertionError(f"audio: rerank {sims} against the CPU's {cpu_sims}")

        # (e) the inference CLI's function on one .wav.
        args = add_inference_args(ArgumentParser()).parse_args(
            ["--model-path", str(ckpt / "clipcap_final.npz"), "--config-path",
             str(ckpt / "clipcap_config.yaml"), "--sample-path", str(clips[0]),
             "--device", str(dev), "--number-to-generate", "5"])
        flash_decode.launches = 0
        log = io.StringIO()
        with warnings.catch_warnings(), contextlib.redirect_stdout(log):
            warnings.simplefilter("ignore")
            rc = inference_demo(args)
        launches["cli"] = flash_decode.launches
        lines = log.getvalue().splitlines()
        if rc != 0 or sum(ln.startswith("sim ") for ln in lines) != 5 or "best" not in lines[-1]:
            raise AssertionError(f"audio: inference CLI exit {rc}, output {lines}")
        print(f"audio: inference CLI on {clips[0].name}: 5 captions; {lines[-1]!r}")

        # (f) eval on 32 clips, five references each, batch 32 x 5.
        launches["eval"] = run_audio_eval(dev, ckpt, clips[:AUDIO_EVAL], workdir)
        print(f"audio: flash_decode launches {launches}")
        for key in ("beam", "sampling", "cli", "eval"):
            if launches[key] == 0:
                raise AssertionError(f"audio: {key} never launched flash_decode")

        # Information: HTSAT-tiny b64 fp32 embeds/s, a profile of one batch,
        # and the rerank's text tower at 5 and 160 captions.
        g = torch.Generator(device=dev).manual_seed(3)
        inputs = [0.1 * torch.randn(AUDIO_BATCH, 480_000, generator=g, device=dev)
                  for _ in range(3)]

        @torch.no_grad()
        def embed(x):
            return clap_audio_embedding(encoder.audio, x)

        per_trial = rate(embed, inputs, AUDIO_BATCH)
        med = statistics.median(per_trial)
        print(f"time [{tag}] HTSAT-tiny b{AUDIO_BATCH} fp32 (10 s at 48 kHz, log-mel on the "
              f"card): embeds/s per trial {per_trial}; median {med:.1f}")
        profile(embed, inputs[0], AUDIO_BATCH * 1e3 / med, f"HTSAT-tiny b{AUDIO_BATCH} fp32",
                tag, top=10)
        words = [" ".join(np.random.default_rng(i).choice(AUDIO_WORDS, 8))
                 for i in range(max(RERANK_SIZES))]
        for n in RERANK_SIZES:
            encoder.encode_text(words[:n])
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(5):
                encoder.encode_text(words[:n])
            sync(dev)
            print(f"time [{tag}] CLAP rerank text tower (RoBERTa-base + projection, fp32, 77 "
                  f"tokens) at {n} captions: {(time.perf_counter() - t0) / 5 * 1e3:.2f} ms a call")
        del inputs, encoder, cpu_encoder, model
    print(f"audio: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def run_audio_eval(dev, ckpt: Path, clips, workdir: Path) -> int:
    """Phase 11f: ``clipcap_tpu_torch.eval`` on ``clips`` with a seeded
    five-reference CSV, batch 32 x 5, fp32.  Returns the decode kernel's
    launches."""
    import pandas as pd

    from clipcap_tpu_torch.eval import base
    from clipcap_tpu_torch.ops.flash_decode import flash_decode

    folder = workdir / "eval_clips"
    folder.mkdir()
    rng = np.random.default_rng(14)
    for f in clips:
        shutil.copy(f, folder / f.name)
    pd.DataFrame([{"file_name": f.name, **{f"ref_{j}": " ".join(rng.choice(AUDIO_WORDS, 6))
                                           for j in range(1, 6)}} for f in clips]
                 ).to_csv(workdir / "audio_refs.csv", index=False)
    argv = ["--model-path", str(ckpt / "clipcap_final.npz"), "--config-path",
            str(ckpt / "clipcap_config.yaml"), "--sample-path", str(folder), "--reference-csv",
            str(workdir / "audio_refs.csv"), "--csv-filename-column", "file_name",
            "--csv-reference-caption-columns", "ref_{1..5}", "--eval-batch-size", str(len(clips)),
            "--number-to-generate", "5", "--allow-fallback-tokenizer", "--device", str(dev),
            "--save-predictions", str(workdir / "audio_preds.json"), "--save-file",
            str(workdir / "audio_scores.json")]
    flash_decode.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings(), contextlib.redirect_stdout(io.StringIO()):
        warnings.simplefilter("ignore")
        rc = base.run_eval(argv)
    sync(dev)
    n = flash_decode.launches
    preds = json.loads((workdir / "audio_preds.json").read_text())
    scores = json.loads((workdir / "audio_scores.json").read_text())
    print(f"audio: eval exit {rc} in {time.perf_counter() - t0:.1f} s; {len(preds)} predictions; "
          f"scores {({k: scores.get(k) for k in EVAL_METRICS})}; flash_decode launches {n}")
    bad = [k for k in EVAL_METRICS if not isinstance(scores.get(k), (int, float))
           or not math.isfinite(scores[k])]
    if rc != 0 or sorted(preds) != sorted(f.name for f in clips) or bad:
        raise AssertionError(f"audio: eval exit {rc}, {len(preds)} predictions, bad {bad}")
    return n


# ---------------------------------------------------------------------------
# Phase 12: the CLIP ResNet towers (RN50 family)
# ---------------------------------------------------------------------------

RN_BATCH, RN_DIM, RN64_BATCH, RN_CHECK = 256, 1024, 32, 8


def write_rn50_checkpoint(root: Path) -> Path:
    """Phase 12: a seeded RN50 (both towers) in OpenAI's layout and fp16, as
    ``clip.load``'s files are."""
    from clipcap_tpu_torch.convert import clip_from_params
    from clipcap_tpu_torch.models.clip_vit import get_clip_config, init_clip

    cfg = get_clip_config("RN50")
    path = root / "RN50.pt"
    sd = clip_from_params(init_clip(cfg, seed=21), cfg).state_dict()
    torch.save({k: v.half() for k, v in sd.items()}, path)
    return path


def run_resnet(dev, raw: Path, workdir: Path, tag: str) -> dict:
    """Phase 12: RN50 through ``$CLIPCAP_CLIP_CHECKPOINT`` (OpenAI layout,
    so ``clip_config_from_openai``'s RN branch runs): preprocess at batch
    256 on phase 8's first 256 images (no ``patch_embed`` launch), the fp32
    tower on the card against the CPU, ``similarity`` (``sdpa_packed`` in
    the text tower), a beam-5 caption from an RN50-conditioned checkpoint
    (``flash_decode``); RN50x64 at 448 px, one seeded bf16 batch of 32.
    Information: RN50 b256 and RN50x64 b32 bf16 embeds/s, a profile of one
    RN50 batch.  Returns the launches of rows 1, 2 and 5 on this path."""
    from clipcap_tpu_torch import generate_beam, get_encoder_from_model, load
    from clipcap_tpu_torch.config import Config, EncoderConfig, save_yaml_config
    from clipcap_tpu_torch.convert import resnet_from_params
    from clipcap_tpu_torch.encoders.clip import get_clip_encoder
    from clipcap_tpu_torch.models.clip_resnet import ModifiedResNet, init_clip_resnet
    from clipcap_tpu_torch.models.clip_vit import clip_encode_image, get_clip_config
    from clipcap_tpu_torch.models.clipcap import init_clipcap
    from clipcap_tpu_torch.models.gpt2 import get_gpt2_config
    from clipcap_tpu_torch.ops.attention import sdpa_packed
    from clipcap_tpu_torch.ops.flash_decode import flash_decode
    from clipcap_tpu_torch.ops.patch_embed import patch_embed
    from clipcap_tpu_torch.train.checkpoint import save_params

    t_phase = time.perf_counter()
    ckpt = write_rn50_checkpoint(workdir)
    part = raw / "rn50"
    part.mkdir()
    for i in range(RN_BATCH):
        for ext in (".jpg", ".txt"):
            shutil.copy(raw / "files" / f"img_{i:05d}{ext}", part / f"img_{i:05d}{ext}")
    captions = [(part / f"img_{i:05d}.txt").read_text() for i in range(RN_BATCH)]
    print(f"resnet: seeded RN50 checkpoint (OpenAI layout, fp16) written in "
          f"{time.perf_counter() - t_phase:.1f} s")
    launches = {}
    with mock.patch.dict(os.environ, {"CLIPCAP_CLIP_CHECKPOINT": str(ckpt)}):
        built = []
        patch_embed.launches = sdpa_packed.launches = 0
        preprocess_cli(dev, "RN50", ["--input-dataset", str(part), "--output-folder",
                                     str(workdir / "out_rn50")],
                       built, RN_BATCH, variant="RN50", batch=RN_BATCH)
        launches["preprocess_patch_embed"] = patch_embed.launches
        check_dataset(workdir / "out_rn50", [captions], "RN50", dim=RN_DIM, variant="RN50")
        encoder, transform = built[0]
        if not isinstance(encoder.model.visual, ModifiedResNet) or patch_embed.launches:
            raise AssertionError(f"resnet: preprocess took the ViT path ({patch_embed.launches} "
                                 "patch_embed launches)")
        print(f"resnet: preprocess launched patch_embed {patch_embed.launches} times (gate 0); "
              f"config {encoder.config.name}")

        # fp32 RN50 on the card against the CPU, 8 images.
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            card, _ = get_clip_encoder("RN50", device=dev, dtype=torch.float32)
            cpu, _ = get_clip_encoder("RN50", device="cpu", dtype=torch.float32)
        batch = np.stack([transform(str(part / f"img_{i:05d}.jpg")) for i in range(RN_CHECK)])
        got, want = card(batch), cpu(batch)
        err = rel_err(got, want)
        print(f"resnet: RN50 fp32, {RN_CHECK} images on the card vs the CPU: ‖d‖/‖ref‖ "
              f"{err:.3g} (gate 1e-3)")
        if got.shape != (RN_CHECK, RN_DIM) or not np.isfinite(got).all() or not err <= 1e-3:
            raise AssertionError(f"resnet: card vs CPU {err}")

        # The rerank: similarity launches sdpa_packed in the text tower.
        sdpa_packed.launches = 0
        sims = card.similarity(batch[0], ["a photo of noise", "a dog", "static on a screen"])
        sync(dev)
        launches["similarity_sdpa_packed"] = sdpa_packed.launches
        cpu_sims = cpu.similarity(batch[0], ["a photo of noise", "a dog", "static on a screen"])
        print(f"resnet: RN50 similarity {np.round(sims, 4).tolist()} (CPU max|d| "
              f"{np.abs(sims - cpu_sims).max():.3g}); sdpa_packed launches "
              f"{launches['similarity_sdpa_packed']}")
        if sims.shape != (3,) or not np.isfinite(sims).all() or sdpa_packed.launches == 0:
            raise AssertionError("resnet: similarity did not launch sdpa_packed")
        del cpu, built, encoder

        # A short beam-5 caption from an RN50-conditioned checkpoint.
        config = Config(language_model="gpt2", prefix_length=P, projection_length=P,
                        transformer_layers=8, transformer_attention_heads=8,
                        encoder_config=EncoderConfig(encoder_model_name="clip",
                                                     encoder_model_variant="RN50",
                                                     encoder_embedding_size=RN_DIM))
        save_params(str(workdir / "rn50_model.npz"),
                    init_clipcap(config, lm_config=get_gpt2_config("gpt2"), seed=1).params())
        save_yaml_config(config, str(workdir / "rn50_config.yaml"))
        model, tokenizer = load(str(workdir / "rn50_model.npz"),
                                str(workdir / "rn50_config.yaml"), device=dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            encoder, transform = get_encoder_from_model(model)
        flash_decode.launches = 0
        prefix = model.transformer_mapper(encoder(batch[:1]))
        beams = generate_beam(model, tokenizer, prefix, number_to_generate=5, beam_size=K,
                              entry_length=20)
        sync(dev)
        launches["beam_flash_decode"] = flash_decode.launches
        print(f"resnet: RN50-conditioned beam 5 (20 new tokens): {len(beams)} captions, best "
              f"{beams[0]!r}; flash_decode launches {flash_decode.launches}")
        if not isinstance(encoder.model.visual, ModifiedResNet) or flash_decode.launches == 0:
            raise AssertionError("resnet: the RN50 caption did not launch flash_decode")

        # Information: RN50 b256 bf16 embeds/s and a profile of one batch.
        visual = copy.deepcopy(card.model.visual).to(torch.bfloat16)
        del card, model, encoder
        g = torch.Generator(device=dev).manual_seed(8)
        inputs = [torch.randint(0, 256, (RN_BATCH, 224, 224, 3), generator=g, device=dev,
                                dtype=torch.uint8) for _ in range(3)]

        @torch.no_grad()
        def embed(x):
            return clip_encode_image(visual, x, dtype=torch.bfloat16)

        per_trial = rate(embed, inputs, RN_BATCH)
        med = statistics.median(per_trial)
        print(f"time [{tag}] RN50 b{RN_BATCH} bf16 uint8 224 px: embeds/s per trial "
              f"{per_trial}; median {med:.1f}")
        profile(embed, inputs[0], RN_BATCH * 1e3 / med, f"RN50 b{RN_BATCH} bf16", tag, top=10)
        del visual, inputs

    # RN50x64 at its own 448 px: one seeded bf16 batch of 32.
    t0 = time.perf_counter()
    cfg = get_clip_config("RN50x64").vision
    visual = resnet_from_params(init_clip_resnet(cfg, seed=22), cfg).to(dev, torch.bfloat16)
    print(f"resnet: seeded RN50x64 tower on the card in {time.perf_counter() - t0:.1f} s")
    inputs = [torch.randint(0, 256, (RN64_BATCH, cfg.image_size, cfg.image_size, 3),
                            generator=g, device=dev, dtype=torch.uint8) for _ in range(3)]

    @torch.no_grad()
    def embed64(x):
        return clip_encode_image(visual, x, dtype=torch.bfloat16)

    out = embed64(inputs[0])
    if tuple(out.shape) != (RN64_BATCH, RN_DIM) or not torch.isfinite(out).all():
        raise AssertionError(f"resnet: RN50x64 b{RN64_BATCH} gave {tuple(out.shape)}")
    per_trial = rate(embed64, inputs, RN64_BATCH)
    print(f"resnet: RN50x64 b{RN64_BATCH} bf16 at {cfg.image_size} px: finite "
          f"[{RN64_BATCH}, {RN_DIM}]")
    print(f"time [{tag}] RN50x64 b{RN64_BATCH} bf16 uint8 {cfg.image_size} px: embeds/s per "
          f"trial {per_trial}; median {statistics.median(per_trial):.1f}")
    del visual, inputs, out
    print(f"resnet: launches {launches}; phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# Phase 13: DeepSeek-V2-Lite's routed experts at the caption cell's decode
# step: 640 rows (128 images × beam 5), each token's top 6 of 64 experts.
DSV2_E, DSV2_D, DSV2_F, DSV2_TOKENS, DSV2_TOPK = 64, 2048, 1408, 640, 6


def dsv2_expert_rows(dev, g, kind: str):
    """The token-expert rows of a decode step sorted by expert, and the
    device offsets: the top 6 of 640 tokens' random router logits,
    ``skewed`` (a ramp favours the first experts) or ``one_empty`` (expert
    17 never chosen)."""
    from clipcap_tpu_torch.ops import moe

    logits = torch.randn(DSV2_TOKENS, DSV2_E, generator=g, device=dev)
    if kind == "skewed":
        logits += torch.linspace(4, 0, DSV2_E, device=dev)
    if kind == "one_empty":
        logits[:, 17] = -1e9
    order, _, offsets = moe.expert_groups(logits.topk(DSV2_TOPK, dim=-1).indices, DSV2_E)
    x = torch.randn(DSV2_TOKENS, DSV2_D, generator=g, device=dev, dtype=torch.bfloat16)
    return x[order // DSV2_TOPK].contiguous(), offsets


def run_dsv2(dev, tag: str) -> dict:
    """Phase 13 (see the module docstring); returns the kernel's row, its
    ``launches`` those of the full-width search (:func:`dsv2_main_path`)."""
    import torch.nn.functional as F

    from clipcap_tpu_torch.inference import beam as beam_mod
    from clipcap_tpu_torch.models import deepseek_v2 as dsv2
    from clipcap_tpu_torch.ops import moe

    E, D, Fw = DSV2_E, DSV2_D, DSV2_F
    g = torch.Generator(device=dev).manual_seed(13)
    w13 = torch.randn(E, 2 * Fw, D, generator=g, device=dev, dtype=torch.bfloat16) * 0.02
    w2 = torch.randn(E, D, Fw, generator=g, device=dev, dtype=torch.bfloat16) * 0.02
    row = {"name": "grouped_expert_mlp", "route": "cuda",
           "source": "clipcap_tpu_torch/csrc/moe_grouped.cu", "replaces": None}
    launches = moe.grouped_expert_mlp.launches
    for kind in ("random", "skewed", "one_empty"):
        x, off = dsv2_expert_rows(dev, g, kind)
        got = moe.grouped_expert_mlp(x, w13, w2, off)
        want = moe.grouped_expert_mlp_ref(x, w13, w2, off)
        err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        counts = torch.diff(off)
        print(f"check [{tag}] grouped_expert_mlp {kind}: {x.shape[0]} rows, "
              f"{int((counts == 0).sum())} empty experts, up to {int(counts.max())} rows an "
              f"expert; max error {err:.3g} of the output's scale")
        if not err < TOL[torch.bfloat16]:
            raise AssertionError(f"grouped_expert_mlp {kind}: error {err}")
        row[f"rel_err_{kind}"] = err
    if moe.grouped_expert_mlp.launches != launches + 6:
        raise AssertionError("grouped_expert_mlp did not launch its kernels")

    x, off = dsv2_expert_rows(dev, g, "random")
    M, counts = x.shape[0], torch.diff(off)
    used = int((counts > 0).sum())
    row.update(bound((used * 3 * D * Fw + 2 * M * D) * 2, 6 * M * D * Fw, torch.bfloat16))
    row.update(timed(lambda: moe.grouped_expert_mlp(x, w13, w2, off)))
    row.update(timed(lambda: moe.grouped_expert_mlp_ref(x, w13, w2, off), "twin_"))
    bounds = off.tolist()

    def matmul_loop():
        out = torch.empty_like(x)
        for e in range(E):
            lo, hi = bounds[e], bounds[e + 1]
            if lo < hi:
                gu = torch.matmul(x[lo:hi], w13[e].t())
                out[lo:hi] = torch.matmul(F.silu(gu[:, :Fw]) * gu[:, Fw:], w2[e].t())
        return out

    row.update(timed(matmul_loop, "loop_"))
    ends = off[1:].contiguous()

    def grouped_mm():
        gu = torch._grouped_mm(x, w13.transpose(1, 2), offs=ends)
        return torch._grouped_mm(F.silu(gu[:, :Fw]) * gu[:, Fw:], w2.transpose(1, 2), offs=ends)

    try:
        row.update(timed(grouped_mm, "library_"))
    except (AttributeError, RuntimeError) as exc:
        print(f"time [{tag}] torch._grouped_mm: not timed ({str(exc).splitlines()[0]})")
    print(f"time [{tag}] grouped_expert_mlp ({M} rows over {used} of {E} experts, D {D}, "
          f"F {Fw}): " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                   for k, v in row.items() if k.endswith(("ms", "by"))))

    cfg = dataclasses.replace(dsv2.DSV2_PRESETS["deepseek-v2-test"], hidden_size=256,
                              intermediate_size=512, moe_intermediate_size=128,
                              num_attention_heads=2, kv_lora_rank=64, qk_nope_head_dim=32,
                              qk_rope_head_dim=16, v_head_dim=32, num_experts_per_tok=3,
                              vocab_size=1000, name="smoke")
    lm = dsv2.init_dsv2(cfg, seed=13).to(dev, torch.bfloat16)
    prefix = torch.randn(8, P, cfg.hidden_size, generator=g, device=dev)
    bp = beam_mod.BeamParams(beam_size=K, max_new_tokens=12, stop_token=-1)
    steps = beam_mod.beam_search_batched.graph_steps
    beam_mod.beam_search_batched(lm, prefix, bp)
    graphed = beam_mod.beam_search_batched(lm, prefix, bp)
    with mock.patch.object(beam_mod, "decode_step_graphs", lambda *a, **k: None):
        eager = beam_mod.beam_search_batched(lm, prefix, bp)
    same = all(torch.equal(a, b) for a, b in zip(graphed, eager))
    print(f"check [{tag}] DeepSeek-V2 beam search: {beam_mod.beam_search_batched.graph_steps - steps} "
          f"graphed steps; graphed == eager: {same}")
    if not same:
        raise AssertionError("graphed DeepSeek-V2 decode steps differ from eager ones")
    del lm, w13, w2
    row.update(dsv2_main_path(dev, tag))
    return row


def dsv2_main_path(dev, tag: str) -> dict:
    """DeepSeek-V2-Lite at its published widths, seeded bf16 on the card,
    under the caption cell's beam search (128 prefixes × beam K, N_NEW new
    tokens): the grouped kernels launch twice per MoE layer in the prefill
    and in every decode step, and no expert runs through ``torch.matmul``
    or ``torch._grouped_mm``.  Counts the second search (the first captures
    the decode graphs) → the row's ``launches`` and the search's time."""
    from clipcap_tpu_torch.inference import beam as beam_mod
    from clipcap_tpu_torch.models import deepseek_v2 as dsv2
    from clipcap_tpu_torch.ops import moe

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dsv2.DSV2_PRESETS["deepseek-ai/DeepSeek-V2-Lite"]
    g = torch.Generator(device=dev).manual_seed(17)
    with torch.device("meta"):
        shapes = [(n, p.shape) for n, p in dsv2.DeepseekV2(cfg).named_parameters()]
    sd = {n: (torch.ones(s, dtype=torch.bfloat16, device=dev) if "norm" in n else
              torch.empty(s, dtype=torch.bfloat16, device=dev).normal_(0.0, 0.02, generator=g))
          for n, s in shapes}
    lm = dsv2.dsv2_from_state_dict(sd, cfg)
    del sd
    n_moe = sum(cfg.is_moe(i) for i in range(cfg.num_hidden_layers))
    prefix = torch.randn(128, P, cfg.hidden_size, generator=g, device=dev)
    bp = beam_mod.BeamParams(beam_size=K, max_new_tokens=N_NEW, stop_token=-1)
    f = beam_mod.beam_search_batched
    f(lm, prefix, bp)
    steps, graph_steps = f.decode_steps, f.graph_steps
    moe.grouped_expert_mlp.launches = 0
    with mock.patch.object(torch, "_grouped_mm", create=True,
                           side_effect=AssertionError("an expert ran through _grouped_mm")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = f(lm, prefix, bp)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = moe.grouped_expert_mlp.launches
    decode_steps, graphed = f.decode_steps - steps, f.graph_steps - graph_steps
    want = 2 * n_moe * (1 + decode_steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"check [{tag}] DeepSeek-V2-Lite at its widths (seeded bf16), beam-{K} b128, {N_NEW} "
          f"new tokens: {launches} grouped-kernel launches (want 2 x {n_moe} MoE layers x (1 prefill "
          f"+ {decode_steps} decode steps) = {want}); {graphed} of {decode_steps} steps graphed; "
          f"{seconds:.3f} s, {128 / seconds:.2f} captions/s; peak {peak:.2f} GiB")
    if launches != want:
        raise AssertionError(f"grouped_expert_mlp launched {launches} times, want {want}")
    if not bool(torch.isfinite(res.scores).all()):
        raise AssertionError("DeepSeek-V2-Lite beam scores are not finite")
    del lm, prefix, res
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "main_path_decode_steps": decode_steps,
            "main_path_s": seconds}


KIMI_R, KIMI_H, KIMI_D = 96, 32, 128      # the Kimi cell's samples, KDA heads, head size


def kda_step_inputs(dev, g, kind: str, dtype=torch.bfloat16):
    """One KDA decode step of the Kimi cell (96 samples × K beams, 32 heads
    of 128): the projections, taps, decay, β, and each row's parent within
    its sample, ``random``, ``repeated`` (two parents a sample) or ``one``
    (all K beams on one parent)."""
    B, HD = KIMI_R * K, KIMI_H * KIMI_D
    x = torch.randn(3, B, HD, generator=g, device=dev).to(dtype) * 2
    taps = (torch.randn(3, HD, 1, 4, generator=g, device=dev) * 0.5).to(dtype)
    gl = -torch.rand(B, KIMI_H, KIMI_D, generator=g, device=dev)
    beta = torch.rand(B, KIMI_H, generator=g, device=dev)
    beams = {"random": torch.randint(0, K, (B,), generator=g, device=dev),
             "repeated": torch.randint(0, 2, (B,), generator=g, device=dev) * 2,
             "one": torch.full((B,), 3, device=dev)}[kind]
    parent = (torch.arange(B, device=dev) // K * K + beams).to(torch.int32)
    return x, taps, gl, beta, parent


def run_kimi(dev, tag: str) -> dict:
    """Phase 14 (see the module docstring); returns the kernel's row."""
    from clipcap_tpu_torch.inference import beam as beam_mod
    from clipcap_tpu_torch.models import kimi_linear as km
    from clipcap_tpu_torch.ops import kda

    B, HD = KIMI_R * K, KIMI_H * KIMI_D
    g = torch.Generator(device=dev).manual_seed(14)
    row = {"name": "kda_decode", "route": "cuda",
           "source": "clipcap_tpu_torch/csrc/kda_decode.cu", "replaces": None}
    launches = kda.kda_decode.launches
    for kind in ("random", "repeated", "one"):
        x, taps, gl, beta, parent = kda_step_inputs(dev, g, kind)
        win = [torch.randn(B, 3, 3, HD, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(2)]
        st = [torch.randn(B, KIMI_H, KIMI_D, KIMI_D, generator=g, device=dev) * 0.1
              for _ in range(2)]
        twin_win, twin_st = [w.clone() for w in win], [s.clone() for s in st]
        fresh = torch.full_like(parent, -1)
        for t, par in enumerate((fresh, parent)):
            args = (x[0], x[1], x[2], *taps, gl, beta, par)
            got = kda.kda_decode(*args, win[t], win[1 - t], st[t], st[1 - t], K)
            want = kda.kda_decode_ref(*args, twin_win[t], twin_win[1 - t], twin_st[t],
                                      twin_st[1 - t], K)
            err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
            st_err = float((st[1 - t] - twin_st[1 - t]).abs().max())
            same_win = torch.equal(win[1 - t], twin_win[1 - t])
            print(f"check [{tag}] kda_decode {kind} step {t}: output error {err:.3g} of its "
                  f"scale, state error {st_err:.3g}, windows equal: {same_win}")
            if not (err < TOL[torch.bfloat16] and st_err < 1e-4 and same_win):
                raise AssertionError(f"kda_decode {kind} step {t}: error {err}, {st_err}")
            row[f"rel_err_{kind}_{t}"] = err
    if kda.kda_decode.launches != launches + 6:
        raise AssertionError("kda_decode did not launch its kernel")

    x, taps, gl, beta, parent = kda_step_inputs(dev, g, "random")
    st = [torch.zeros(B, KIMI_H, KIMI_D, KIMI_D, device=dev) for _ in range(2)]
    win = [torch.zeros(B, 3, 3, HD, device=dev, dtype=torch.bfloat16) for _ in range(2)]
    args = (x[0], x[1], x[2], *taps, gl, beta, parent, win[0], win[1], st[0], st[1], K)
    parents = int(parent.unique().numel())
    state = KIMI_H * KIMI_D * KIMI_D * 4
    nbytes = (parents + B) * state + (parents + B) * 3 * 3 * HD * 2 + 3 * B * HD * 2 \
        + B * KIMI_H * (KIMI_D * 4 + 4) + B * HD * 2 + 3 * HD * 4 * 2
    row.update(bound(nbytes, B * KIMI_H * 7 * KIMI_D * KIMI_D, torch.float32))
    row.update(timed(lambda: kda.kda_decode(*args)))
    row.update(timed(lambda: kda.kda_decode_ref(*args), "twin_"))
    print(f"time [{tag}] kda_decode ({B} rows, {parents} distinct parents, {KIMI_H} heads of "
          f"{KIMI_D}): " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                     for k, v in row.items() if k.endswith(("ms", "by"))))
    del x, st, win, args

    cfg = dataclasses.replace(
        km.KIMI_PRESETS["kimi-linear-test"], hidden_size=256, intermediate_size=512,
        moe_intermediate_size=128, num_attention_heads=2, kv_lora_rank=64, qk_nope_head_dim=32,
        qk_rope_head_dim=16, v_head_dim=32, num_experts=16, num_experts_per_token=4,
        experts_held=(4, 12), vocab_size=1000, name="smoke",
        linear_attn_config=km.LinearAttnConfig(kda_layers=(1, 2, 4), full_attn_layers=(3,),
                                               head_dim=128, num_heads=2))
    lm = km.init_kimi(cfg, seed=14).to(dev, torch.bfloat16)
    prefix = torch.randn(8, P, cfg.hidden_size, generator=g, device=dev)
    bp = beam_mod.BeamParams(beam_size=K, max_new_tokens=12, stop_token=-1)
    steps = beam_mod.beam_search_batched.graph_steps
    beam_mod.beam_search_batched(lm, prefix, bp)
    graphed = beam_mod.beam_search_batched(lm, prefix, bp)
    with mock.patch.object(beam_mod, "decode_step_graphs", lambda *a, **k: None):
        eager = beam_mod.beam_search_batched(lm, prefix, bp)
    same = all(torch.equal(a, b) for a, b in zip(graphed, eager))
    graphed_steps = beam_mod.beam_search_batched.graph_steps - steps
    print(f"check [{tag}] Kimi-Linear beam search: {graphed_steps} graphed steps; "
          f"graphed == eager: {same}")
    if not same:
        raise AssertionError("graphed Kimi-Linear decode steps differ from eager ones")
    del lm
    row.update(kimi_main_path(dev, tag))
    return row


def kimi_main_path(dev, tag: str) -> dict:
    """Kimi-Linear-48B-A3B at its published widths, 32 of 256 experts held,
    seeded bf16 on the card, under the caption cell's beam search (96
    prefixes × beam K, N_NEW new tokens): the KDA kernel launches once per
    KDA layer at each prefix position and each decode step.  Counts the
    second search (the first captures the decode graphs)."""
    from clipcap_tpu_torch.inference import beam as beam_mod
    from clipcap_tpu_torch.models import kimi_linear as km
    from clipcap_tpu_torch.ops import kda

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = km.KIMI_PRESETS["moonshotai/Kimi-Linear-48B-A3B-Instruct"]
    g = torch.Generator(device=dev).manual_seed(18)
    with torch.device("meta"):
        shapes = [(n, p.shape) for n, p in km.KimiLinear(cfg).named_parameters()]
    sd = {}
    for n, shape in shapes:
        leaf = n.rsplit(".", 1)[-1]
        if "norm" in n:
            sd[n] = torch.ones(shape, dtype=torch.bfloat16, device=dev)
        elif leaf == "bias":
            sd[n] = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        elif leaf == "A_log":
            sd[n] = torch.rand(shape, generator=g, device=dev).mul(15).add(1).log().bfloat16()
        elif leaf == "dt_bias":
            sd[n] = km.inverse_softplus_dt(torch.rand(shape, generator=g, device=dev)).bfloat16()
        else:
            sd[n] = torch.empty(shape, dtype=torch.bfloat16, device=dev).normal_(0.0, 0.02,
                                                                                 generator=g)
    with torch.device("meta"):
        lm = km.KimiLinear(cfg)
    lm.load_state_dict(sd, assign=True)
    del sd
    n_kda = sum(cfg.is_kda(i) for i in range(cfg.num_hidden_layers))
    prefix = torch.randn(KIMI_R, P, cfg.hidden_size, generator=g, device=dev)
    bp = beam_mod.BeamParams(beam_size=K, max_new_tokens=N_NEW, stop_token=-1)
    f = beam_mod.beam_search_batched
    f(lm, prefix, bp)
    steps, graph_steps = f.decode_steps, f.graph_steps
    kda.kda_decode.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = f(lm, prefix, bp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kda.kda_decode.launches
    decode_steps, graphed = f.decode_steps - steps, f.graph_steps - graph_steps
    want = n_kda * (P + decode_steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"check [{tag}] Kimi-Linear-48B-A3B at its widths (32 of 256 experts, seeded bf16), "
          f"beam-{K} b{KIMI_R}, {N_NEW} new tokens: {launches} KDA launches (want {n_kda} KDA "
          f"layers x ({P} prefix positions + {decode_steps} decode steps) = {want}); {graphed} "
          f"of {decode_steps} steps graphed; {seconds:.3f} s, {KIMI_R / seconds:.2f} captions/s; "
          f"peak {peak:.2f} GiB")
    if launches != want:
        raise AssertionError(f"kda_decode launched {launches} times, want {want}")
    if not bool(torch.isfinite(res.scores).all()):
        raise AssertionError("Kimi-Linear beam scores are not finite")
    del lm, prefix, res
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "main_path_decode_steps": decode_steps,
            "main_path_s": seconds}


GRANITE_R, GRANITE_H, GRANITE_C = 64, 128, 128 * 64 + 2 * 128   # samples, heads, xBC


def mamba_step_inputs(dev, g, kind: str, dtype=torch.bfloat16):
    """One Mamba decode step of the Granite cell (64 samples × K beams, 128
    heads of 64, a state of 128): the step's xBC and dt (views of one
    ``in_proj`` row, as the decode step passes them), the convolution's taps
    and bias, A_log, D, dt_bias, and each row's parent within its sample,
    ``random``, ``repeated`` (two parents a sample) or ``one`` (all K beams
    on one parent)."""
    B, H, C = GRANITE_R * K, GRANITE_H, GRANITE_C
    zxbcdt = torch.randn(B, 8192 + C + H, generator=g, device=dev).to(dtype)
    xbc, dt = zxbcdt[:, 8192:8192 + C], zxbcdt[:, 8192 + C:]
    w = (torch.rand(C, 1, 4, generator=g, device=dev) - 0.5).to(dtype)
    b = (torch.rand(C, generator=g, device=dev) - 0.5).to(dtype)
    A_log = torch.rand(H, generator=g, device=dev).mul(15).add(1).log().to(dtype)
    D = torch.ones(H, device=dev, dtype=dtype)
    dt_bias = (torch.rand(H, generator=g, device=dev) * -4 - 2).to(dtype)
    beams = {"random": torch.randint(0, K, (B,), generator=g, device=dev),
             "repeated": torch.randint(0, 2, (B,), generator=g, device=dev) * 2,
             "one": torch.full((B,), 3, device=dev)}[kind]
    parent = (torch.arange(B, device=dev) // K * K + beams).to(torch.int32)
    return (xbc, dt, w, b, A_log, D, dt_bias), parent


def run_granite(dev, tag: str) -> dict:
    """Phase 15 (see the module docstring); returns the kernel's row."""
    from clipcap_tpu_torch.inference import beam as beam_mod
    from clipcap_tpu_torch.models import granite_hybrid as gh
    from clipcap_tpu_torch.ops import mamba

    B, H, C = GRANITE_R * K, GRANITE_H, GRANITE_C
    g = torch.Generator(device=dev).manual_seed(15)
    row = {"name": "mamba_decode", "route": "cuda",
           "source": "clipcap_tpu_torch/csrc/mamba_decode.cu", "replaces": None}
    launches = mamba.mamba_decode.launches
    for kind in ("random", "repeated", "one"):
        args, parent = mamba_step_inputs(dev, g, kind)
        win = [torch.randn(B, 3, C, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(2)]
        st = [(torch.randn(B, H, 64, 128, generator=g, device=dev) * 0.1).to(torch.bfloat16)
              for _ in range(2)]
        twin_win, twin_st = [w.clone() for w in win], [s.clone() for s in st]
        fresh = torch.full_like(parent, -1)
        for t, par in enumerate((fresh, parent)):
            got = mamba.mamba_decode(*args, par, win[t], win[1 - t], st[t], st[1 - t], K)
            want = mamba.mamba_decode_ref(*args, par, twin_win[t], twin_win[1 - t], twin_st[t],
                                          twin_st[1 - t], K)
            err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
            st_err = float((st[1 - t].float() - twin_st[1 - t].float()).abs().max()
                           / twin_st[1 - t].float().abs().max())
            same_win = torch.equal(win[1 - t], twin_win[1 - t])
            print(f"check [{tag}] mamba_decode {kind} step {t}: output error {err:.3g} of its "
                  f"scale, state error {st_err:.3g} of its scale, windows equal: {same_win}")
            if not (err < TOL[torch.bfloat16] and st_err < TOL[torch.bfloat16] and same_win):
                raise AssertionError(f"mamba_decode {kind} step {t}: error {err}, {st_err}")
            row[f"rel_err_{kind}_{t}"] = err
    if mamba.mamba_decode.launches != launches + 6:
        raise AssertionError("mamba_decode did not launch its kernel")

    args, parent = mamba_step_inputs(dev, g, "random")
    st = [torch.zeros(B, H, 64, 128, device=dev, dtype=torch.bfloat16) for _ in range(2)]
    win = [torch.zeros(B, 3, C, device=dev, dtype=torch.bfloat16) for _ in range(2)]
    call = (*args, parent, win[0], win[1], st[0], st[1], K)
    parents = int(parent.unique().numel())
    per_row = H * 64 * 128 * 2 + 3 * C * 2
    nbytes = ((parents + B) * per_row + B * (C + H) * 2 + B * H * 64 * 2
              + (C * 5 + 3 * H) * 2 + 4 * B)
    row.update(bound(nbytes, B * H * 5 * 64 * 128, torch.float32))
    row.update(timed(lambda: mamba.mamba_decode(*call)))
    row.update(timed(lambda: mamba.mamba_decode_ref(*call), "twin_"))
    print(f"time [{tag}] mamba_decode ({B} rows, {parents} distinct parents, {H} heads of 64, "
          f"state 128): " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                      for k, v in row.items() if k.endswith(("ms", "by"))))
    del args, st, win, call

    cfg = dataclasses.replace(
        gh.GRANITE_PRESETS["granite-hybrid-test"], hidden_size=256, intermediate_size=128,
        shared_intermediate_size=256, num_attention_heads=2, num_key_value_heads=1,
        mamba_n_heads=8, mamba_d_head=64, mamba_d_state=128, num_local_experts=16,
        num_experts_per_tok=4, experts_held=(4, 12), vocab_size=1000, name="smoke")
    lm = gh.init_granite(cfg, seed=15).to(dev, torch.bfloat16)
    prefix = torch.randn(8, P, cfg.hidden_size, generator=g, device=dev)
    bp = beam_mod.BeamParams(beam_size=K, max_new_tokens=12, stop_token=-1)
    steps = beam_mod.beam_search_batched.graph_steps
    beam_mod.beam_search_batched(lm, prefix, bp)
    graphed = beam_mod.beam_search_batched(lm, prefix, bp)
    with mock.patch.object(beam_mod, "decode_step_graphs", lambda *a, **k: None):
        eager = beam_mod.beam_search_batched(lm, prefix, bp)
    same = all(torch.equal(a, b) for a, b in zip(graphed, eager))
    graphed_steps = beam_mod.beam_search_batched.graph_steps - steps
    print(f"check [{tag}] Granite-4.0-H beam search: {graphed_steps} graphed steps; "
          f"graphed == eager: {same}")
    if not same:
        raise AssertionError("graphed Granite-4.0-H decode steps differ from eager ones")
    del lm
    row.update(granite_main_path(dev, tag))
    return row


# Phase 16's shapes: ViT-L/14 b256's and ViT-B/32 b128's c_fc outputs.
QUICK_GELU_SHAPES = {"ViT-L/14 b256": (256, 257, 4096), "ViT-B/32 b128": (128, 50, 3072)}


def quick_gelu_misses(got, x, dy=None) -> int:
    """Elements of a QuickGELU kernel's bf16 output (``dy`` given: the input
    gradient) more than one bf16 ulp (floored at 2^-20) off the float32
    formula."""
    from clipcap_tpu_torch.ops.quick_gelu import quick_gelu_backward_plain, quick_gelu_plain

    want = (quick_gelu_plain(x.float()) if dy is None
            else quick_gelu_backward_plain(x.float(), dy.float()))
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -13))) - 7)
    return int(((got.float() - want).abs() > ulp).sum())


def run_quick_gelu(dev, tag: str) -> dict:
    """Phase 16 (see the module docstring); returns the kernel's row."""
    from clipcap_tpu_torch.ops.quick_gelu import quick_gelu, quick_gelu_plain

    row = {"name": "quick_gelu", "route": "cuda",
           "source": "clipcap_tpu_torch/csrc/quick_gelu.cu", "replaces": None}
    g = torch.Generator(device=dev).manual_seed(16)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for label, shape in QUICK_GELU_SHAPES.items():
        x = (torch.randn(shape, generator=g, device=dev) * 3).bfloat16()
        dy = torch.randn(shape, generator=g, device=dev).bfloat16()
        leaf = x.clone().requires_grad_()
        n0 = quick_gelu.launches
        y = quick_gelu(leaf)
        (dx,) = torch.autograd.grad(y, leaf, dy, retain_graph=True)
        torch.cuda.synchronize()
        launches = quick_gelu.launches - n0
        misses = (quick_gelu_misses(y.detach(), x), quick_gelu_misses(dx, x, dy))
        print(f"check [{tag}] quick_gelu {label} bf16 {tuple(shape)}: forward / backward "
              f"elements more than one bf16 ulp off the float32 formula {misses}; launches "
              f"{launches} (one a call each way)")
        if misses != (0, 0) or launches != 2:
            raise AssertionError(f"quick_gelu {label}: {misses} off, {launches} launches (want 2)")
        del dx
        chain_leaf = x.clone().requires_grad_()
        chain = quick_gelu_plain(chain_leaf)
        nbytes = 2 * x.numel() * x.element_size()
        t = {"forward": {**timed(lambda: quick_gelu(x)), **timed(lambda: quick_gelu_plain(x),
                                                                  "plain_"),
                         **bound(nbytes, 5 * x.numel(), torch.bfloat16)},
             "backward": {**timed(lambda: torch.autograd.grad(y, leaf, dy, retain_graph=True)),
                          **timed(lambda: torch.autograd.grad(chain, chain_leaf, dy,
                                                              retain_graph=True), "plain_"),
                          **bound(3 * x.numel() * x.element_size(), 9 * x.numel(),
                                  torch.bfloat16)}}
        if label == "ViT-B/32 b128":    # 39 MB in, 39 MB out: partly L2-resident back to back
            t["forward"]["cold_device_ms"] = device_ms(lambda: (flush.zero_(), quick_gelu(x)),
                                                       only="quick_gelu")
        for way, r in t.items():
            if r["device_ms"] is not None:
                r["bound_share"] = r["bound_ms"] / r["device_ms"]
            print(f"time [{tag}] quick_gelu {way} {label} bf16 {tuple(shape)}: "
                  + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                              for k, v in r.items()))
        row["vit_l14_b256" if label.startswith("ViT-L") else "vit_b32_b128"] = t
        del x, dy, leaf, y, chain_leaf, chain
    return row


def granite_main_path(dev, tag: str) -> dict:
    """Granite-4.0-H-Small at its published widths, 9 of 72 experts held,
    seeded bf16 on the card, under the caption cell's beam search (64
    prefixes × beam K, N_NEW new tokens): the Mamba kernel launches once per
    Mamba layer at each prefix position and each decode step.  Counts the
    second search (the first captures the decode graphs)."""
    from clipcap_tpu_torch.inference import beam as beam_mod
    from clipcap_tpu_torch.models import granite_hybrid as gh
    from clipcap_tpu_torch.models.kimi_linear import inverse_softplus_dt
    from clipcap_tpu_torch.ops import mamba

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = gh.GRANITE_PRESETS["ibm-granite/granite-4.0-h-small"]
    g = torch.Generator(device=dev).manual_seed(19)
    with torch.device("meta"):
        shapes = [(n, p.shape) for n, p in gh.GraniteHybrid(cfg).named_parameters()]
    sd = {}
    for n, shape in shapes:
        leaf = n.rsplit(".", 1)[-1]
        if "norm" in n or leaf == "D":
            sd[n] = torch.ones(shape, dtype=torch.bfloat16, device=dev)
        elif ".conv1d." in n:
            sd[n] = (torch.rand(shape, generator=g, device=dev) - 0.5).bfloat16()
        elif leaf == "A_log":
            sd[n] = torch.rand(shape, generator=g, device=dev).mul(15).add(1).log().bfloat16()
        elif leaf == "dt_bias":
            sd[n] = inverse_softplus_dt(torch.rand(shape, generator=g, device=dev)).bfloat16()
        else:
            sd[n] = torch.empty(shape, dtype=torch.bfloat16, device=dev).normal_(0.0, 0.02,
                                                                                 generator=g)
    with torch.device("meta"):
        lm = gh.GraniteHybrid(cfg)
    lm.load_state_dict(sd, assign=True)
    del sd
    n_mamba = sum(cfg.is_mamba(i) for i in range(cfg.num_hidden_layers))
    prefix = torch.randn(GRANITE_R, P, cfg.hidden_size, generator=g, device=dev)
    bp = beam_mod.BeamParams(beam_size=K, max_new_tokens=N_NEW, stop_token=-1)
    f = beam_mod.beam_search_batched
    f(lm, prefix, bp)
    steps, graph_steps = f.decode_steps, f.graph_steps
    mamba.mamba_decode.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = f(lm, prefix, bp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = mamba.mamba_decode.launches
    decode_steps, graphed = f.decode_steps - steps, f.graph_steps - graph_steps
    want = n_mamba * (P + decode_steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"check [{tag}] Granite-4.0-H-Small at its widths (9 of 72 experts, seeded bf16), "
          f"beam-{K} b{GRANITE_R}, {N_NEW} new tokens: {launches} Mamba launches (want "
          f"{n_mamba} Mamba layers x ({P} prefix positions + {decode_steps} decode steps) = "
          f"{want}); {graphed} of {decode_steps} steps graphed; {seconds:.3f} s, "
          f"{GRANITE_R / seconds:.2f} captions/s; peak {peak:.2f} GiB")
    if launches != want:
        raise AssertionError(f"mamba_decode launched {launches} times, want {want}")
    if not bool(torch.isfinite(res.scores).all()):
        raise AssertionError("Granite-4.0-H beam scores are not finite")
    del lm, prefix, res
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "main_path_decode_steps": decode_steps,
            "main_path_s": seconds, "main_path_peak_gib": peak}


def run_phases(dev, workdir: Path, name_limit: str, host_line: str, errors: dict) -> list:
    """Phases 3-16 in ``workdir``; returns the kernels' rows.  Phase 10's
    paths run beside the phases whose models and data they reuse: 10a
    after 6, 10c after 8, 10b after 9; phase 12 reuses phase 8's images."""
    slice_dir, train_dir = workdir / "slice", workdir / "train"
    slice_dir.mkdir()
    train_dir.mkdir()
    model, encoder, launches = run_slice(dev, slice_dir)
    fused_launches, facade_err = run_sdpa_facade(dev)
    times = time_kernels(dev, name_limit)
    beam, beam_inputs = beam_workload(model, dev)
    beam_cps = rate(beam, beam_inputs, 128)
    print(f"time [{name_limit}] beam-5 GPT-2 b128 bf16 ({N_NEW} new tokens): captions/s "
          f"per trial {beam_cps}")
    vit, vit_inputs = vit_workload(encoder, dev)
    embeds = rate(vit, vit_inputs, 512)
    print(f"time [{name_limit}] ViT-B/32 b512 bf16 uint8 (patch embedding by the patch_embed "
          f"kernel): embeds/s per trial {embeds}")
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
    print(host_memory())
    adamw_row = run_training(dev, train_dir, name_limit)
    embedding = torch.from_numpy(
        np.load(train_dir / "dataset" / "embeddings" / "embeds_0.npy")[0]).to(dev)
    adamw_row["finetune_launches"] = run_finetune_export(dev, train_dir / "dataset", train_dir,
                                                         embedding)
    shutil.rmtree(train_dir)          # its checkpoints: no later phase reads them
    torch.cuda.empty_cache()
    print(host_memory())
    xl_rows, bf16_weights = run_xl(dev, slice_dir, name_limit)
    gc.collect()
    torch.cuda.empty_cache()
    print(host_memory())
    pre_dir = workdir / "preprocess"
    pre_dir.mkdir()
    patch_row, pre_sdpa_launches, l14_rates, clip, file_captions = run_preprocess(
        dev, pre_dir, name_limit)
    w8a8_launches = run_w8a8(dev, clip, pre_dir / "raw", pre_dir, file_captions,
                             l14_rates["kernel"], name_limit)
    del clip
    gc.collect()
    torch.cuda.empty_cache()
    print(host_memory())
    eval_dir = workdir / "eval"
    eval_dir.mkdir()
    manual_launches, eval_row = run_eval_phase(dev, slice_dir, eval_dir, name_limit)
    print(host_memory())
    gc.collect()
    torch.cuda.empty_cache()
    qlm, xl_prefix, int8w_launches = int8_weight_gates(dev, slice_dir, eval_dir)
    int8_weight_timings(qlm, xl_prefix, dev, bf16_weights, name_limit)
    del qlm, xl_prefix
    print(host_memory())
    gc.collect()
    torch.cuda.empty_cache()
    audio_dir = workdir / "audio"
    audio_dir.mkdir()
    audio_launches = run_audio(dev, audio_dir, name_limit)
    shutil.rmtree(audio_dir)
    gc.collect()
    torch.cuda.empty_cache()
    print(host_memory())
    rn_launches = run_resnet(dev, pre_dir / "raw", pre_dir, name_limit)
    shutil.rmtree(pre_dir)
    print(host_memory())
    dsv2_row = run_dsv2(dev, name_limit)
    gc.collect()
    torch.cuda.empty_cache()
    kimi_row = run_kimi(dev, name_limit)
    gc.collect()
    torch.cuda.empty_cache()
    granite_row = run_granite(dev, name_limit)
    gc.collect()
    torch.cuda.empty_cache()
    quick_gelu_row = run_quick_gelu(dev, name_limit)

    def row(name, source, replaces, **numbers):
        return {"name": name, "route": "cuda", "source": f"clipcap_tpu_torch/csrc/{source}",
                "replaces": replaces, **numbers}

    return [
        row("flash_decode", "flash_decode.cu", "clipcap_tpu/ops/flash_decode.py:407",
            launches=launches["flash_decode"], max_abs_err=errors["flash_decode"],
            **times["flash_decode"],
            int8_weights_launches={k: int8w_launches[k] for k in ("xl_fp32_r4", "cli", "eval")},
            clap_launches={k: audio_launches[k] for k in ("beam", "sampling", "cli", "eval")},
            rn50_beam_launches=rn_launches["beam_flash_decode"]),
        row("sdpa_packed", "sdpa.cu", "clipcap_tpu/ops/attention.py:244",
            launches=launches["sdpa_packed"], max_abs_err=errors["sdpa_packed"],
            **times["sdpa_packed"], text_b5=times["sdpa_packed_text_b5"],
            vit_l14_b256={"launches": pre_sdpa_launches, **times["sdpa_packed_vit_l14"]},
            vit_l14_336_b256=times["sdpa_packed_vit_l14_336"],
            w8a8_preprocess_launches=w8a8_launches["sdpa_packed"],
            int8_weights_eval_launches=int8w_launches["eval_sdpa_packed"],
            rn50_similarity_launches=rn_launches["similarity_sdpa_packed"]),
        dict(adamw_row, clap_train_launches=audio_launches["fused_adamw"]),
        row("flash_decode_int8", "flash_decode.cu", "clipcap_tpu/ops/flash_decode.py:407",
            max_abs_err=errors["flash_decode_int8"], **xl_rows["flash_decode_int8"]),
        row("flash_decode_two_phase", "flash_decode.cu", "clipcap_tpu/ops/flash_decode.py:784",
            max_abs_err=errors["flash_decode_two_phase"], **xl_rows["flash_decode_two_phase"]),
        row("patch_embed", "patch_embed.cu", "clipcap_tpu/ops/patch_embed.py:112",
            max_abs_err=errors["patch_embed"], **patch_row,
            w8a8_preprocess_launches=w8a8_launches["patch_embed"],
            rn50_preprocess_launches=rn_launches["preprocess_patch_embed"]),
        row("fused_sdpa", "sdpa.cu", "clipcap_tpu/ops/attention.py:75",
            launches=fused_launches, max_abs_err=max(errors["fused_sdpa"], facade_err),
            **times["fused_sdpa"], vit_b32_b512=times["fused_sdpa_vit_b32"]),
        row("flash_decode_manual", "flash_decode.cu", "clipcap_tpu/ops/flash_decode.py:576",
            launches=manual_launches, max_abs_err=errors["flash_decode_manual"],
            **xl_rows["flash_decode_manual"], eval_r160=eval_row),
        row("flash_decode_tile_major", "flash_decode.cu", "clipcap_tpu/ops/flash_decode.py:310",
            max_abs_err=errors["flash_decode_tile_major"],
            **xl_rows["flash_decode_tile_major"]),
        dsv2_row,
        kimi_row,
        granite_row,
        quick_gelu_row,
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

    t_start = t0 = time.perf_counter()
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

    from clipcap_tpu_torch.inference.beam import beam_search_batched as beam
    from clipcap_tpu_torch.utils.profiling import ONCE
    print(f"decode graphs: {beam.graph_steps} of {beam.decode_steps} beam decode steps "
          f"replayed them, {ONCE.counts.get('graphs.capture', 0)} segments captured "
          f"in {ONCE.totals.get('graphs.capture', 0.0):.2f} s")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(name_limit)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
