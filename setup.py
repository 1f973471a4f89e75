from setuptools import find_packages, setup

setup(
    name="apertis-llm",
    version="0.1.0",
    description="Apertis LLM framework in JAX (XLA) for NVIDIA GPUs",
    long_description=open("README.md", encoding="utf-8").read(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=["apertis_llm_tpu", "apertis_llm_tpu.*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.35",
        "numpy",
        "optax",
        "orbax-checkpoint",
        "pyyaml",
        "pillow",
        "requests",
    ],
    extras_require={
        "hf": ["transformers", "tokenizers"],
        "ui": ["gradio>=4.0"],
        "data": ["beautifulsoup4", "pyarrow"],
        "spark": ["pyspark>=3.4"],
        "torch-interop": ["torch"],
        "dev": ["pytest"],
    },
    entry_points={
        "console_scripts": [
            "apertis=apertis_llm_tpu.cli:main",
        ],
    },
)
