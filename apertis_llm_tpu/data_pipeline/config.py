"""Data pipeline configuration (YAML dataclass tree).

Same schema as the reference (reference: src/data_pipeline/config.py:5-146)
plus a ``backend`` selector: ``local`` (multiprocessing, default — runs
anywhere and feeds a single strong accelerator host) or ``spark`` (PySpark cluster,
used when pyspark is installed).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, List, Optional

import yaml


@dataclass
class SparkConfig:
    master: str = "local[*]"
    driver_memory: str = "16g"
    executor_memory: str = "8g"
    num_executors: Optional[int] = None
    executor_cores: int = 4
    extra_configs: Dict[str, Any] = field(default_factory=lambda: {
        "spark.sql.execution.arrow.pyspark.enabled": "true",
        "spark.serializer": "org.apache.spark.serializer.KryoSerializer",
        "spark.kryoserializer.buffer.max": "2047m",
        "spark.sql.shuffle.partitions": "200",
    })


@dataclass
class DownloadConfig:
    source: str = "common_crawl"
    warc_paths_url: Optional[str] = (
        "https://data.commoncrawl.org/crawl-data/CC-MAIN-2023-50/warc.paths.gz")
    num_warc_files: int = 1000
    output_dir: str = "data/pipeline/raw_warc"
    num_partitions: int = 200


@dataclass
class CleanConfig:
    input_dir: str = "data/pipeline/raw_warc"
    output_dir: str = "data/pipeline/cleaned_text"
    min_text_length: int = 256
    max_text_length: int = 100000
    fasttext_model_path: str = "models/lid.176.bin"
    language_whitelist: List[str] = field(default_factory=lambda: ["en"])
    num_partitions: int = 200


@dataclass
class DeduplicateConfig:
    input_dir: str = "data/pipeline/cleaned_text"
    output_dir: str = "data/pipeline/deduplicated_text"
    minhash_threshold: float = 0.8
    num_minhash_permutations: int = 128
    lsh_num_bands: int = 16
    num_partitions: int = 200
    connected_components_iterations: int = 10


@dataclass
class TokenizeConfig:
    input_dir: str = "data/pipeline/deduplicated_text"
    output_dir: str = "data/pipeline/tokenized"
    tokenizer_path: str = "gpt2"
    max_seq_length: int = 2048
    output_format: str = "parquet"
    num_partitions: int = 200


@dataclass
class DataPipelineConfig:
    spark: SparkConfig = field(default_factory=SparkConfig)
    download: DownloadConfig = field(default_factory=DownloadConfig)
    clean: CleanConfig = field(default_factory=CleanConfig)
    deduplicate: DeduplicateConfig = field(default_factory=DeduplicateConfig)
    tokenize: TokenizeConfig = field(default_factory=TokenizeConfig)
    stages: List[str] = field(default_factory=lambda: [
        "download", "clean", "deduplicate", "tokenize"])
    backend: str = "local"  # "local" | "spark"
    num_workers: Optional[int] = None  # local backend parallelism

    @classmethod
    def from_yaml(cls, path: str) -> "DataPipelineConfig":
        with open(path, "r") as f:
            data = yaml.safe_load(f) or {}
        return _dataclass_from_dict(cls, data)


def _dataclass_from_dict(data_class, data):
    if not is_dataclass(data_class) or not isinstance(data, dict):
        return data
    kwargs = {}
    for f in fields(data_class):
        if f.name not in data:
            continue
        value = data[f.name]
        default = f.default_factory() if callable(f.default_factory) else None  # type: ignore[misc]
        if is_dataclass(default):
            kwargs[f.name] = _dataclass_from_dict(type(default), value)
        else:
            kwargs[f.name] = value
    return data_class(**kwargs)


def create_sample_pipeline_config(output_path: str) -> None:
    from dataclasses import asdict

    sample = asdict(DataPipelineConfig())
    with open(output_path, "w") as f:
        yaml.dump(sample, f, indent=2, sort_keys=False, default_flow_style=False)
