"""CPU self-check of the benchmark's yardstick (not a measurement).

    python3 portbench/selfcheck.py

1. The plain reference against the port, float32, at tiny sizes: the CLIP
   image tower, the mapper, GPT-2's logits, the training loss and one
   AdamW step, each within 1e-4 relative error.
2. The FLOP counts of ``flops.py`` against ``torch.utils.flop_counter``
   run over the reference's own forward (ViT-B/32 on one image, the
   mapper at GPT-2 width, GPT-2 124M over 16 positions).
3. The byte counts of the roofline metrics against hand counts of the
   bounds that ``chip_smoke.py`` printed (PERF.md §6, rows 1, 2 and 5).
"""
import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from portbench import flops, weights  # noqa: E402
from portbench.peaks import bound_s  # noqa: E402
from portbench.reference import clip_vit, gpt2, mapper, train  # noqa: E402
from portbench.reference.numerics import Numerics  # noqa: E402

F32 = Numerics("fp32")


def rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def reference_vs_port(cfg: dict) -> dict:
    from clipcap_tpu_torch.models.clip_vit import clip_encode_image
    from clipcap_tpu_torch.models.clipcap import clipcap_loss
    from clipcap_tpu_torch.models.gpt2 import gpt2_apply
    from clipcap_tpu_torch.models.mapper import mapper_apply
    from clipcap_tpu_torch.ops.fused_adamw import adamw_scalars, fused_adamw_ref

    from portbench import program

    cpu, f32, seed = torch.device("cpu"), torch.float32, 11
    g = torch.Generator().manual_seed(0)
    out = {}
    enc = program.image_encoder(cfg, seed, cpu, f32)
    imgs = torch.randint(0, 256, (3, 32, 32, 3), generator=g, dtype=torch.uint8)
    Wc = weights.clip_visual(cfg, seed, cpu, f32)
    emb = clip_encode_image(enc.model.visual, imgs, dtype=f32)
    out["vit"] = rel(emb, clip_vit.vit_encode(Wc, imgs, cfg["encoder"], F32))
    m = program.mapper(cfg, seed, cpu, f32)
    Wm = weights.mapper(cfg, seed, cpu, f32)
    out["mapper"] = rel(mapper_apply(m, emb, dtype=f32),
                        mapper.mapper_prefix(Wm, emb, cfg["mapper"], F32))
    lm = program.language_model(cfg, seed, cpu, f32)
    Wlm = weights.gpt2(cfg, seed, cpu, f32)
    x = torch.randn(2, 9, cfg["language_model"]["n_embd"], generator=g)
    logits, _ = gpt2_apply(lm, inputs_embeds=x, dtype=f32)
    out["gpt2"] = rel(logits, gpt2.lm_logits(Wlm, gpt2.gpt2_hidden(Wlm, x, cfg["language_model"],
                                                                  F32), F32))
    model = program.clipcap(cfg, seed, cpu, f32)
    tokens = torch.randint(1, 50256, (3, 6), generator=g)
    tokens[0, 4:] = -1
    e = torch.randn(3, cfg["mapper"]["encoder_embedding_size"], generator=g)
    out["loss"] = rel(clipcap_loss(model, tokens, e, dtype=f32),
                      train.clipcap_loss(Wm, Wlm, tokens, e, cfg, F32))
    p = [torch.randn(5, 7, generator=g) for _ in range(2)]
    grads = [torch.randn(5, 7, generator=g) for _ in p]
    mine = [[t.clone() for t in p], [torch.zeros(5, 7) for _ in p], [torch.zeros(5, 7) for _ in p]]
    fused_adamw_ref(mine[0], grads, mine[1], mine[2], adamw_scalars(1e-3, 0.9, 0.999, 1e-8, 0.01, 1))
    theirs = [[t.clone() for t in p], [torch.zeros(5, 7) for _ in p], [torch.zeros(5, 7) for _ in p]]
    train.adamw_step(theirs[0], grads, theirs[1], theirs[2], 1, 1e-3)
    out["adamw"] = max(rel(a - q, b - q) for a, b, q in zip(mine[0], theirs[0], p))
    return out


def counted(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc, torch.no_grad():
        fn()
    return fc.get_total_flops()


def flop_counts() -> dict:
    cfg = json.loads((HERE / "configs" / "vitb32-gpt2.json").read_text())
    cpu, f32 = torch.device("cpu"), torch.float32
    imgs = torch.zeros(1, 224, 224, 3, dtype=torch.uint8)
    Wc = weights.clip_visual(cfg, 0, cpu, f32)
    Wm = weights.mapper(cfg, 0, cpu, f32)
    Wlm = weights.gpt2(cfg, 0, cpu, f32)
    lm = cfg["language_model"]
    x = torch.zeros(1, 16, lm["n_embd"])
    return {
        "vit_image": (flops.vit_image(cfg["encoder"]),
                      counted(lambda: clip_vit.vit_encode(Wc, imgs, cfg["encoder"], F32))),
        "mapper_sample": (flops.mapper_sample(cfg["mapper"]),
                          counted(lambda: mapper.mapper_prefix(Wm, torch.zeros(1, 512),
                                                               cfg["mapper"], F32))),
        # the reference computes all 16×16 pairs (the mask hides half)
        "gpt2_positions": (flops.gpt2_positions(lm, 16, 16 * 16, 16),
                           counted(lambda: gpt2.lm_logits(Wlm, gpt2.gpt2_hidden(Wlm, x, lm, F32),
                                                          F32))),
    }


def metric(name: str):
    spec = importlib.util.spec_from_file_location(name, HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bounds() -> dict:
    """Each metric's bound at a shape whose bound PERF.md §6 prints."""
    from clipcap_tpu_torch.models.gpt2 import beam_mask

    bf = torch.bfloat16
    R, H, K, P, step = 128, 12, 5, 10, 40
    u = P + (step + 1) * K
    q = torch.zeros(R, H, K, 64, dtype=bf)
    kv = torch.zeros(R, H, 384, 128, dtype=bf)
    mask = beam_mask(torch.zeros(R * K, 67, dtype=torch.long), K, 384, offset=P + step,
                     cache_base=P)
    fd = metric("flash_decode_roofline").facts(q, kv, mask, u)
    sd = metric("sdpa_packed_roofline").facts(torch.zeros(256, 257, 3 * 1024, dtype=bf), 16)
    pe = metric("patch_embed_roofline").facts(torch.zeros(256, 224, 224, 3, dtype=torch.uint8),
                                              torch.zeros(588, 1024, dtype=bf),
                                              torch.zeros(1024, dtype=bf), 14)
    return {"flash_decode (row 1: 0.0260 ms)": (bound_s(*fd) * 1e3, 0.0260),
            "sdpa_packed L/14 b256 (row 2: 0.1609 ms)": (bound_s(*sd) * 1e3, 0.1609),
            "patch_embed L/14 b256 (row 5: 0.0798 ms)": (bound_s(*pe) * 1e3, 0.0798)}


def main() -> int:
    tiny = json.loads((HERE / "tests" / "tiny.json").read_text())
    failed = []
    for k, v in reference_vs_port(tiny).items():
        print(f"reference vs port, float32, {k}: relative error {v:.3g}")
        failed += [k] if not v < 1e-4 else []
    for k, (mine, torch_count) in flop_counts().items():
        print(f"FLOPs {k}: flops.py {mine:.6g}, flop_counter {torch_count:.6g}")
        failed += [k] if abs(mine - torch_count) > 1e-9 * torch_count + 0.5 else []
    for k, (ms, printed) in bounds().items():
        print(f"bound {k}: {ms:.4f} ms")
        failed += [k] if abs(ms - printed) > 5e-5 else []
    print("selfcheck:", "FAILED " + ", ".join(failed) if failed else "ok")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
