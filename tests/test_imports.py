"""Import smoke tests: every module loads (the analog of the reference's
test_docker.py / test_windows_compatibility.py import checks)."""

import importlib

import pytest

MODULES = [
    "apertis_llm_tpu",
    "apertis_llm_tpu.config",
    "apertis_llm_tpu.cli",
    "apertis_llm_tpu.ops.attention",
    "apertis_llm_tpu.ops.ssm",
    "apertis_llm_tpu.ops.moe",
    "apertis_llm_tpu.ops.rope",
    "apertis_llm_tpu.ops.norms",
    "apertis_llm_tpu.ops.sampling",
    "apertis_llm_tpu.ops.activations",
    "apertis_llm_tpu.ops.quant",
    "apertis_llm_tpu.ops.moe_ep",
    "apertis_llm_tpu.backend",
    "apertis_llm_tpu.models.apertis",
    "apertis_llm_tpu.models.params",
    "apertis_llm_tpu.models.factory",
    "apertis_llm_tpu.models.convert",
    "apertis_llm_tpu.models.vit",
    "apertis_llm_tpu.models.quantize",
    "apertis_llm_tpu.models.moe_fuse",
    "apertis_llm_tpu.parallel.mesh",
    "apertis_llm_tpu.parallel.sharding",
    "apertis_llm_tpu.parallel.context",
    "apertis_llm_tpu.parallel.sequence",
    "apertis_llm_tpu.parallel.pipeline",
    "apertis_llm_tpu.parallel.ring_attention",
    "apertis_llm_tpu.inference.engine",
    "apertis_llm_tpu.inference.interface",
    "apertis_llm_tpu.inference.ui",
    "apertis_llm_tpu.training",
    "apertis_llm_tpu.training.step",
    "apertis_llm_tpu.training.trainer",
    "apertis_llm_tpu.training.pp_step",
    "apertis_llm_tpu.training.pipeline",
    "apertis_llm_tpu.training.datasets",
    "apertis_llm_tpu.training.azr",
    "apertis_llm_tpu.training.azr_pipeline",
    "apertis_llm_tpu.data_pipeline.config",
    "apertis_llm_tpu.data_pipeline.main",
    "apertis_llm_tpu.data_pipeline.minhash",
    "apertis_llm_tpu.data_pipeline.warc",
    "apertis_llm_tpu.data_pipeline.clean",
    "apertis_llm_tpu.data_pipeline.download",
    "apertis_llm_tpu.data_pipeline.tokenize",
    "apertis_llm_tpu.utils.vocab",
    "apertis_llm_tpu.utils.images",
    "apertis_llm_tpu.utils.checkpoint",
    "apertis_llm_tpu.utils.profiling",
    "apertis_llm_tpu.utils.jax_cache",
    "apertis_llm_tpu.native",
]


@pytest.mark.parametrize("module", MODULES)
def test_module_imports(module):
    importlib.import_module(module)


def test_cli_help():
    from apertis_llm_tpu.cli import build_parser

    parser = build_parser()
    commands = {a.dest for a in parser._subparsers._group_actions[0].choices.values()
                for a in []} if False else set(
        parser._subparsers._group_actions[0].choices.keys())
    assert commands == {"chat", "train", "create-model", "create-config",
                        "data-pipeline", "create-pipeline-config", "eval"}
