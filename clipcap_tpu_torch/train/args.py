"""Training CLI args: the flags of ``clipcap_tpu/train/args.py`` (itself at
parity with the reference's), for the port on one device.

What differs:

* ``--device`` names one CUDA index, or ``cpu``; ``-1`` is the one visible
  GPU.  Several devices wait for ROADMAP.md A9;
* ``--fused-optimizer`` selects the CUDA fused-AdamW kernel
  (``csrc/fused_adamw.cu``);
* ``--profile-dir`` writes a ``torch.profiler`` trace;
* the distributed flags are accepted as in the JAX package; on one device
  ZeRO-1 changes nothing, and tensor parallelism raises.
"""
from argparse import ArgumentParser

from clipcap_tpu_torch.utils.argtypes import str2bool


def add_training_args(parser: ArgumentParser) -> ArgumentParser:
    training = parser.add_argument_group("training")
    training.add_argument("--batch-size", type=int, default=64,
                          help="Number of samples contained in each batch.")
    training.add_argument("--epochs", type=int, default=5,
                          help="Number of training cycles of the training data before exiting.")
    training.add_argument("--optimizer-lr", type=float, default=2e-5,
                          help="Optimizer learning rate.")
    training.add_argument("--scheduler-warmup-steps", type=int, default=5000,
                          help="LR scheduler warmup duration in steps.")
    training.add_argument("--fp-precision", type=int, default=32,
                          help="Compute precision: 16 = bfloat16; 32 (and 64, as in the JAX "
                               "package without x64) = float32. Parameters stay float32.")
    training.add_argument("--checkpoint-save-frequency", type=int, default=1,
                          help="Save a new checkpoint every 'n' epochs.")
    training.add_argument("--checkpoint-filename-prefix", type=str, default="clipcap",
                          help="Checkpoint filename prefix.")
    training.add_argument("--device", type=str, default="-1",
                          help="'<n>' for CUDA device n, '-1' for the one visible GPU, or "
                               "'cpu'. Several devices are not ported yet (ROADMAP.md A9).")
    training.add_argument("--grad-clip-norm", type=float, default=0.0,
                          help="Global-norm gradient clipping (0 disables).")
    training.add_argument("--fused-optimizer", type=str2bool, default=False,
                          help="Use the CUDA fused-AdamW kernel: one launch per step over "
                               "every trained tensor (csrc/fused_adamw.cu).")
    training.add_argument("--resume-from", type=str, default=None,
                          help="Path to a full train-state .npz (step/params/moments), "
                               "written by either package, to resume from.")
    training.add_argument("--profile-dir", type=str, default=None,
                          help="Write a torch.profiler trace of steps 2-4 into this "
                               "directory (chrome trace JSON).")
    training.add_argument("--remat", type=str2bool, default=None,
                          help="Activation rematerialization. Default: auto (on for "
                               "finetuning or batches >= 128).")

    data = parser.add_argument_group("data")
    data.add_argument("--input-dataset", type=str, default="./dataset/",
                      help="Path to the preprocessed dataset.")
    data.add_argument("--output-folder", type=str, default="./models/",
                      help="Directory to save trained checkpoints to.")
    data.add_argument("--reader-max-piece-size", type=int, default=50,
                      help="Maximum piece size for the embedding reader.")
    data.add_argument("--reader-parallel-pieces", type=int, default=10,
                      help="Number of pieces to read in parallel.")

    dist = parser.add_argument_group("distributed")
    dist.add_argument("--zero1-optimizer-sharding", type=str2bool, default=True,
                      help="Shard optimizer moments over data-parallel devices (ZeRO-1 "
                           "analog); nothing to shard on one device.")
    dist.add_argument("--mesh-model", type=int, default=0,
                      help="Tensor-parallel the LM over M devices: not ported yet "
                           "(ROADMAP.md A9). 0/1 = no tensor parallelism.")
    dist.add_argument("--enable-deepspeed", type=str2bool, default=False,
                      help="[reference-compat] maps onto --zero1-optimizer-sharding.")
    dist.add_argument("--deepspeed-strategy", type=str, default=None,
                      help="[reference-compat] ZeRO stage string (e.g. 'deepspeed_stage_1'). "
                           "Only stage 1 exists; stage 2/3 is an error.")

    wandb = parser.add_argument_group("wandb")
    wandb.add_argument("--enable-wandb", type=str2bool, default=False,
                       help="Enable logging stats to wandb.")
    wandb.add_argument("--wandb-project", type=str, default="clipcap",
                       help="The name of the Wandb project.")
    wandb.add_argument("--logging-frequency", type=int, default=50,
                       help="New data is logged every 'n' steps.")
    return parser
