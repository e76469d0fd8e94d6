"""Model CLI args — the port's own copy of ``clipcap_tpu/models/args.py``,
at flag parity with the reference's model args.

Divergence (documented): the reference's ``type=bool`` flags are always
truthy for any value; here they parse properly via ``str2bool``.  The
reference's heads default mismatch (16 in the config vs 8 here) is preserved as-is for config-file compatibility.
"""
from argparse import ArgumentParser

from clipcap_tpu_torch.utils.argtypes import str2bool


def add_model_args(parser: ArgumentParser) -> ArgumentParser:
    model = parser.add_argument_group("model")
    model.add_argument(
        "--language-model",
        type=str,
        default="gpt2-xl",
        help="GPT-2 family language model (preset name, HF id, or local path).",
    )
    model.add_argument(
        "--prefix-length",
        type=int,
        default=10,
        help="Length in text (LM) embeddings of the prefix placed after the embeddings.",
    )
    model.add_argument(
        "--projection-length",
        type=int,
        default=10,
        help="The number of LM embeddings a single media (e.g. CLIP) embedding should be projected into.",
    )
    model.add_argument(
        "--train-language-model",
        type=str2bool,
        default=False,
        help="Whether or not the language model should remain unfrozen during training.",
    )
    model.add_argument(
        "--transformer-layers",
        type=int,
        default=8,
        help="Number of layers in the mapping transformer.",
    )
    model.add_argument(
        "--transformer-attention-heads",
        type=int,
        default=8,
        help="Number of attention heads in the mapping transformer.",
    )
    model.add_argument(
        "--use-positional-embeddings",
        type=str2bool,
        default=True,
        help="If windowed embeddings were enabled in preprocessing, use positional "
             "embeddings for the windowed sequence in the mapping transformer.",
    )
    return parser
