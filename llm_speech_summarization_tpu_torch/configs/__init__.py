"""The typed configuration: a copy of the JAX package's schema and strict
YAML loader (``configs/config.py``, PyYAML + dataclasses) and of its six
shipped YAMLs under ``configs/yaml/``, so the port reads its own files and
imports nothing of the JAX package."""

from pathlib import Path

from .config import (
    AudioConfig,
    AudioEncoderConfig,
    Config,
    DataConfig,
    LogConfig,
    MeshConfig,
    ModelConfig,
    OptimizerConfig,
    PoolingConfig,
    TrainConfig,
    load_config,
)

YAML_DIR = Path(__file__).resolve().parent / "yaml"

__all__ = [
    "AudioConfig",
    "AudioEncoderConfig",
    "Config",
    "DataConfig",
    "LogConfig",
    "MeshConfig",
    "ModelConfig",
    "OptimizerConfig",
    "PoolingConfig",
    "TrainConfig",
    "YAML_DIR",
    "load_config",
]
