"""Encoder CLI args: the port's own copy of ``clipcap_tpu/encoders/args.py``
(every flag, name, default and group)."""
from argparse import ArgumentParser

from clipcap_tpu_torch.utils.argtypes import str2bool


def add_encoder_args(parser: ArgumentParser) -> ArgumentParser:
    encoder = parser.add_argument_group("encoder")
    encoder.add_argument(
        "--encoder-model-name", choices=["clip", "clap"], type=str, default="clip",
        help="Name of encoder model ('clip' or 'clap').",
    )
    encoder.add_argument(
        "--encoder-model-variant", type=str, default="ViT-L_14",
        help="The specific version of CLIP e.g. 'ViT-L_14' ('_' gets replaced "
             "with a forward slash); for CLAP this selects the audio model "
             "('HTSAT-tiny' etc.).",
    )
    encoder.add_argument(
        "--normalize-embeddings", type=str2bool, default=False,
        help="Whether or not the generated embeddings should be normalized.",
    )
    encoder.add_argument(
        "--encoder-checkpoint-path", type=str, default=None, dest="encoder_checkpoint_path",
        help="Optional local checkpoint for the encoder weights (OpenAI CLIP "
             ".pt / HF CLIPModel / laion_clap .pt).",
    )
    encoder.add_argument(
        "--int8-encoder", type=str2bool, default=False, dest="int8_encoder",
        help="Run the CLIP ViT block projections as w8a8 int8 matmuls. Not "
             "ported yet: true raises NotImplementedError (ROADMAP.md A13).",
    )

    windowed = parser.add_argument_group("windowed")
    windowed.add_argument(
        "--use-windowed-embeddings", type=str2bool, default=False,
        help="Tile the input so more embeddings are generated per sample.",
    )
    windowed.add_argument(
        "--window-size", type=int, default=(4 * 4),
        help="Number of tiles to split the image into (square number), or "
             "audio splices for CLAP.",
    )
    windowed.add_argument(
        "--window-overlap-percentage", type=float, default=0.0,
        help="Percentage each window should overlap into its neighbors.",
    )
    return parser
