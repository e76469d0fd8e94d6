"""Training orchestrator — ``python -m clipcap_tpu_torch.train``.

Counterpart of ``clipcap_tpu/train/train.py`` on one device: read
``encoder_config.yaml``, build the dataloader and find the embedding size,
assemble Config/TrainingConfig (``total_steps = len(dl)·epochs``), build
the model (GPT-2 from disk, or seeded with a warning), train prefix-only
or mapper + GPT-2, and write ``{prefix}_config.yaml``,
``{prefix}_epoch_{e}.npz`` and ``{prefix}_final.npz`` — full train states
that either package loads and resumes from.

Several devices, several processes and tensor parallelism raise
``NotImplementedError`` (ROADMAP.md A9).
"""
from __future__ import annotations

import contextlib
import os
import time
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser, Namespace
from pathlib import Path

import torch
import yaml

from clipcap_tpu_torch.models.args import add_model_args
from clipcap_tpu_torch.config import Config, EncoderConfig, TrainingConfig
from clipcap_tpu_torch.models.clipcap import init_clipcap
from clipcap_tpu_torch.train.args import add_training_args
from clipcap_tpu_torch.train.checkpoint import CheckpointSaver, restore_train_state
from clipcap_tpu_torch.train.dataloader import get_dataloader
from clipcap_tpu_torch.train.state import create_train_state, make_optimizer
from clipcap_tpu_torch.train.step import train_step
from clipcap_tpu_torch.utils.profiling import annotate, trace

PROFILE_STEPS = range(2, 5)    # steps traced by --profile-dir (step 1 warms up)


def resolve_zero_sharding(deepspeed_strategy, zero1_flag, enable_deepspeed) -> bool:
    """The JAX package's mapping of the DeepSpeed flags onto ZeRO-1: stage
    2/3 is an error, not a silent downgrade.  On one device ZeRO-1 shards
    nothing."""
    zero1 = bool(zero1_flag or enable_deepspeed)
    if deepspeed_strategy:
        strategy = str(deepspeed_strategy).lower()
        if any(f"stage_{s}" in strategy or strategy == str(s) for s in (2, 3)):
            raise SystemExit(
                f"--deepspeed-strategy {deepspeed_strategy!r}: only ZeRO stage 1 "
                "(optimizer-moment sharding) is implemented. Use 'deepspeed_stage_1' "
                "or drop the flag.")
        zero1 = True
    return zero1


def select_device(device_arg: str) -> torch.device:
    """``--device``: ``cpu``, one CUDA index, or ``-1`` for the one visible
    GPU.  Without CUDA only an explicit ``cpu`` trains."""
    arg = str(device_arg).strip()
    if arg == "cpu":
        return torch.device("cpu")
    if "," in arg:
        raise NotImplementedError(f"--device {arg}: multi-device training is not ported "
                                  "yet (ROADMAP.md A9)")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {arg!r}: CUDA is not available; pass --device cpu "
                           "to train on the CPU")
    if arg in ("-1", ""):
        n = torch.cuda.device_count()
        if n > 1:
            raise NotImplementedError(
                f"--device -1 selects all {n} GPUs: multi-device training is not ported "
                "yet (ROADMAP.md A9); pass one index, e.g. --device 0")
        return torch.device("cuda", 0)
    return torch.device("cuda", int(arg))


def _check_one_process(args: Namespace) -> None:
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("multi-process training is not ported yet (ROADMAP.md A9)")
    if int(args.mesh_model or 0) > 1:
        raise NotImplementedError(f"--mesh-model {args.mesh_model}: tensor parallelism is "
                                  "not ported yet (ROADMAP.md A9)")


def train(args: Namespace) -> int:
    compute_dtype = torch.bfloat16 if args.fp_precision == 16 else torch.float32
    resolve_zero_sharding(args.deepspeed_strategy, args.zero1_optimizer_sharding,
                          args.enable_deepspeed)
    _check_one_process(args)
    device = select_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)

    with open(Path(args.input_dataset) / "encoder_config.yaml", "r") as f:
        encoder_config = EncoderConfig(**yaml.safe_load(f))
    dataloader, encoder_embedding_size = get_dataloader(
        data_path=args.input_dataset, language_model=args.language_model,
        batch_size=args.batch_size, reader_max_piece_size=args.reader_max_piece_size,
        reader_parallel_pieces=args.reader_parallel_pieces)
    encoder_config.encoder_embedding_size = encoder_embedding_size
    args.total_steps = len(dataloader) * args.epochs

    model_config = Config.from_args(args)
    model_config.training_config = TrainingConfig.from_args(args)
    model_config.encoder_config = encoder_config

    model = init_clipcap(model_config).to(device)
    mode = "prefix + language model" if args.train_language_model else "prefix only"
    print(f"training {mode}; total_steps={args.total_steps}; device {device}")

    tx = make_optimizer(lr=args.optimizer_lr, warmup_steps=args.scheduler_warmup_steps,
                        total_steps=args.total_steps,
                        train_language_model=args.train_language_model,
                        grad_clip_norm=args.grad_clip_norm or None, fused=args.fused_optimizer)
    state = create_train_state(model, tx)
    if args.resume_from:
        state = restore_train_state(args.resume_from, state, tx)
        print(f"resumed from {args.resume_from} at step {state.step}")

    # The JAX package's rule: finetuning always rematerializes; prefix-only
    # from 128 samples per device.  --remat overrides either way.
    remat = (args.train_language_model or args.batch_size >= 128) if args.remat is None \
        else args.remat

    saver = CheckpointSaver(model_config, output_folder=args.output_folder,
                            filename_prefix=str(args.checkpoint_filename_prefix),
                            save_every_n_epochs=args.checkpoint_save_frequency)
    logger = None
    if args.enable_wandb:
        try:
            import wandb

            logger = wandb.init(project=args.wandb_project, config=model_config.to_dict())
        except Exception as e:  # not installed, or offline: train without it
            print(f"wandb disabled ({e})")

    profile = contextlib.ExitStack()    # the --profile-dir trace while it records
    t_mark, seen_mark = time.time(), 0
    seen = 0
    for epoch in range(args.epochs):
        batches = iter(dataloader)
        while True:
            if args.profile_dir and state.step + 1 == PROFILE_STEPS.start:
                profile.callback(print, "profile: " + os.path.join(args.profile_dir,
                                                                   "trace.json"))
                profile.enter_context(trace(args.profile_dir))
            with annotate("train.data_wait"):
                batch = next(batches, None)
            if batch is None:
                break
            tokens, embeds = batch
            tokens = torch.from_numpy(tokens).to(device)
            embeds = torch.from_numpy(embeds).to(device)
            loss = train_step(state, tokens, embeds, tx=tx, dtype=compute_dtype, remat=remat)
            seen += tokens.shape[0]
            if state.step == PROFILE_STEPS.stop - 1:
                profile.close()
            if state.step % args.logging_frequency == 0:
                value = float(loss)
                # The rate since the last line: reading the loss waited for
                # the device, and step 1's warm-up stays in the first line.
                now = time.time()
                rate = (seen - seen_mark) / max(now - t_mark, 1e-9)
                t_mark, seen_mark = now, seen
                print(f"epoch {epoch} step {state.step} loss {value:.4f} "
                      f"({rate:.1f} samples/s)")
                if logger is not None:
                    logger.log({"loss": value, "epoch": epoch, "samples_per_sec": rate},
                               step=state.step)
        saved = saver.on_epoch_end(epoch, state, tx)
        if saved:
            print(f"checkpoint: {saved}")
    profile.close()

    final = saver.save_final_checkpoint(state, tx)
    print(f"final checkpoint: {final}")
    if logger is not None:
        logger.finish()
    return 0


def start_training(argv=None) -> int:
    """The CLI: parse ``argv`` (default: the command line) and train."""
    parser = ArgumentParser(description=__doc__, formatter_class=ArgumentDefaultsHelpFormatter)
    parser = add_training_args(parser)
    parser = add_model_args(parser)
    return train(parser.parse_args(argv))


if __name__ == "__main__":
    exit(start_training())
