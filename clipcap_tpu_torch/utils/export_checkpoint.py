"""Convert a full train-state checkpoint to a serving (params-only) file.

Counterpart of ``clipcap_tpu/utils/export_checkpoint.py``, ``.npz`` only:
a train-state checkpoint written by either package's ``train`` (``step``,
``params::…`` and ``opt_state::…``) is cut to its ``params::`` entries,
the params-only ``.npz`` that ``load`` reads.  Orbax directories are not
ported (ROADMAP.md, A14).

Usage:
    python -m clipcap_tpu_torch.utils.export_checkpoint \\
        --checkpoint models/clipcap_final.npz --output model.npz
"""
from __future__ import annotations

import argparse

import numpy as np


def export_params(checkpoint_path: str, output_path: str, config_path: str = None) -> int:
    """Write the parameters of ``checkpoint_path`` to ``output_path``;
    ``config_path`` is accepted for the JAX CLI's signature (only its orbax
    branch reads it)."""
    from clipcap_tpu_torch.train.checkpoint import SEP

    if not checkpoint_path.endswith(".npz"):
        raise NotImplementedError(f"{checkpoint_path}: only .npz checkpoints are ported "
                                  "(orbax directories are not; ROADMAP.md, A14)")
    flat = dict(np.load(checkpoint_path))
    prefix = f"params{SEP}"
    params_only = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
    if not params_only:  # already params-only
        params_only = flat
    np.savez(output_path, **params_only)
    print(f"wrote params-only checkpoint: {output_path}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True,
                        help="full train-state checkpoint (.npz)")
    parser.add_argument("--output", required=True, help="output .npz path")
    parser.add_argument("--config", default=None,
                        help="model config yaml (read only for orbax checkpoints, which "
                             "are not ported)")
    args = parser.parse_args(argv)
    return export_params(args.checkpoint, args.output, args.config)


if __name__ == "__main__":
    exit(main())
