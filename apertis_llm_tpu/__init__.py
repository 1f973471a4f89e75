"""Apertis: a JAX/XLA LLM framework for NVIDIA GPUs with the full
capability surface of the Apertis reference implementation.

Public API mirrors the reference package layout: config + model factory,
functional model, training pipelines (standard / AZR self-play), inference
interfaces, data pipeline, and the ``apertis`` CLI.
"""

from apertis_llm_tpu.config import ApertisConfig
from apertis_llm_tpu.models.factory import (
    build_model_config,
    calculate_model_dimensions,
    estimate_model_parameters,
    parse_param_count,
)

__version__ = "0.1.0"

__all__ = [
    "ApertisConfig",
    "build_model_config",
    "calculate_model_dimensions",
    "estimate_model_parameters",
    "parse_param_count",
    "__version__",
]
