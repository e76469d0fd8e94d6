from setuptools import find_packages, setup

setup(
    name="clipcap-tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas) captioning-pipeline framework: frozen "
        "contrastive encoders (CLIP/CLAP), mapping networks, GPT-2 decoding, "
        "preprocess/train/inference/eval CLIs"
    ),
    packages=find_packages(include=["clipcap_tpu", "clipcap_tpu.*",
                                    "clipcap_tpu_torch", "clipcap_tpu_torch.*"]),
    # Ship the C++ scorer sources + Makefile so the native extension can
    # auto-build on first use (clipcap_tpu.native.build); the reference
    # instead packaged Java jars (its setup.py:20).
    package_data={
        "clipcap_tpu.native": ["Makefile", "src/*.cpp", "src/*.h"],
        # SPICE parser treebank + pretrained model cache and the METEOR
        # compact synonym table — runtime data the scorers load by default.
        "clipcap_tpu.eval.data": ["*.txt", "*.json.gz"],
        "clipcap_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "optax",
        "pyyaml",
        "fsspec",
        "pandas",
        "pyarrow",
        "pillow",
        "tqdm",
        "regex",
    ],
    extras_require={
        "checkpoint": ["orbax-checkpoint"],
        "hub": ["transformers", "safetensors"],
    },
    entry_points={
        "console_scripts": [
            "clipcap-preprocess=clipcap_tpu.preprocess.preprocess:start_preprocess",
            "clipcap-train=clipcap_tpu.train.train:start_training",
            "clipcap-inference=clipcap_tpu.inference.demo:run_inference_demo",
            "clipcap-eval=clipcap_tpu.eval.base:run_eval",
            "clipcap-finetune=clipcap_tpu.finetune:start_finetuning",
            "clipcap-init=clipcap_tpu.init.base:init",
            # jar-protocol drop-ins (SURVEY §2.2): the reference's own
            # Meteor/PTBTokenizer driver classes can exec these instead of
            # java -jar meteor-1.5.jar / CoreNLP PTBTokenizer.
            "clipcap-meteor=clipcap_tpu.eval.meteor_stdio:main",
            "clipcap-ptbtok=clipcap_tpu.eval.tokenization:main",
        ]
    },
)
