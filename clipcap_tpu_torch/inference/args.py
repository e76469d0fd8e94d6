"""Inference CLI arguments (the JAX package's flags, minus the serving
mesh and ``--int8-weights``, which are not ported)."""
from argparse import ArgumentParser

from clipcap_tpu_torch.utils.argtypes import str2bool


def add_inference_args(parser: ArgumentParser) -> ArgumentParser:
    parser.add_argument("--model-path", type=str, default="./model.ckpt",
                        help="Path to the model: an .npz checkpoint of either package, or a "
                             "reference .ckpt/.pt state dict (converted on load).")
    parser.add_argument("--config-path", type=str, default="./model_config.yaml",
                        help="Path to the config yaml created by the training script.")
    parser.add_argument("--is-checkpoint", type=str2bool, default=False,
                        help="Whether --model-path is a full training checkpoint.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device for the model and the encoder.")

    inference = parser.add_argument_group("inference")
    inference.add_argument("--sample-path", type=str, default="./image.jpg",
                           help="Path to the sample used for inference.")
    inference.add_argument("--number-to-generate", type=int, default=5,
                           help="Number of captions to be generated.")
    inference.add_argument("--text-prefix", type=str, default=None,
                           help="Textual prefix for generated captions (VQA-style), e.g. "
                                "'Q: What is the man doing? A:'.")
    inference.add_argument("--top-p", type=float, default=0.9, help="Inference settings: top_p.")
    inference.add_argument("--top-k", type=int, default=0, help="Inference settings: top_k.")
    inference.add_argument("--temperature", type=float, default=1.0,
                           help="Inference settings: temperature.")
    inference.add_argument("--repetition-penalty", type=float, default=1.2,
                           help="Inference settings: repetition penalty (parsed; the demo "
                                "does not use it, as in the JAX package).")
    inference.add_argument("--desired-sentence-length", type=int, default=50,
                           help="Inference settings: desired sentence length (parsed; the "
                                "demo does not use it, as in the JAX package).")
    inference.add_argument("--seed", type=int, default=0,
                           help="Sampling RNG seed (decoding is deterministic given a seed).")
    inference.add_argument("--int8-kv-cache", action="store_true",
                           help="Serve with an int8 KV cache (per-slot absmax scales): halves "
                                "the decode cache's device memory. Off by default for parity.")
    return parser
