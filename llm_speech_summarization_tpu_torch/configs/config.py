"""Typed configuration schema.

The reference uses untyped OmegaConf attribute access scattered through its
trainer (reference: train.py:24, trainer.py:44-110), which allowed a stale
config (config/config_full.yaml) to ship that would crash at runtime. Here
the schema is explicit: dataclasses with defaults mirroring the canonical
reference config (reference: config/llama3_hubert.yaml), a strict YAML
loader that rejects unknown keys, and TPU-specific additions (mesh axes,
static-shape buckets, dtype policy) grouped under their own sections.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import yaml


@dataclass
class PoolingConfig:
    # reference: config/llama3_hubert.yaml pooling.{kernel_size,stride}
    kernel_size: int = 8
    stride: int = 4


@dataclass
class AudioEncoderConfig:
    # reference: config/llama3_hubert.yaml model.audio_encoder.*
    base: str = "hubert"  # "hubert" | "whisper"
    type: str = "facebook/hubert-large-ls960-ft"  # preset / HF id
    downsample_method: str = "pool"  # "pool" | "stack" | "ctc_pool"
    downsample_factor: int = 4
    pooling: PoolingConfig = field(default_factory=PoolingConfig)
    # TPU additions: model size preset used when `type` is not a known HF id
    # and no converted weights are given (tests use "tiny").
    preset: Optional[str] = None
    # Whisper only: size the mel budget to the (bucketed) input instead of
    # the fixed 30 s pad — a 10 s clip then runs a 1000-frame encoder, not
    # 3000 (PERF.md whisper section). Default False = exact reference
    # featurization (WhisperFeatureExtractor's fixed 30 s pad,
    # reference: trainer.py:178-182). Valid embeds are identical either
    # way (padded frames are attention-masked).
    whisper_dynamic_frames: bool = False


@dataclass
class ModelConfig:
    audio_encoder: AudioEncoderConfig = field(default_factory=AudioEncoderConfig)
    # reference: config/llama3_hubert.yaml model.llm_type
    llm_type: str = "meta-llama/Llama-3.2-3B-Instruct"
    # reference: config/llama3_hubert.yaml model.llm_embedding_channels
    llm_embedding_channels: int = 3072
    # TPU additions
    llm_preset: Optional[str] = None  # overrides llm_type-derived preset
    param_dtype: str = "bfloat16"  # LLM (frozen) parameter dtype
    compute_dtype: str = "bfloat16"  # activations; reference used fp16 AMP
    kv_cache_dtype: Optional[str] = None  # None → compute_dtype; "int8" halves decode KV traffic
    # Serving-only weight quantization: "int8" halves the dominant decode HBM
    # term (weight streaming) via per-channel weight-only quantization +
    # fused-QKV layout. Ignored by training. None → keep param_dtype.
    llm_weight_dtype: Optional[str] = None
    llm_checkpoint: Optional[str] = None  # Orbax dir from cli/convert.py llm
    encoder_checkpoint: Optional[str] = None  # Orbax dir (convert.py encoder or export)
    # Explicit local tokenizer directory (HF format). When set, loading it
    # FAILS LOUDLY on error — a typo'd path must not silently degrade a
    # weights-available run to byte tokens. None → resolve llm_type from the
    # local HF cache, falling back to ByteTokenizer offline.
    tokenizer_path: Optional[str] = None


@dataclass
class AudioConfig:
    # reference: config/llama3_hubert.yaml audio.sampling_rate
    sampling_rate: int = 16000
    # reference: preprocess_data/utils.py:130 (clips > 20 s filtered out)
    max_seconds: float = 20.0


@dataclass
class OptimizerConfig:
    # reference: config/llama3_hubert.yaml train.optimizer.*
    lr: float = 5e-5
    beta1: float = 0.9
    beta2: float = 0.999
    # TPU additions
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    warmup_steps: int = 0


@dataclass
class MeshConfig:
    """Device mesh layout. The reference is single-GPU only
    (reference: README.md:29,86); this section has no reference counterpart.
    """

    data: int = -1  # -1: infer from device count / other axes
    model: int = 1  # tensor-parallel axis size
    seq: int = 1  # sequence-parallel (ring attention) axis size
    axis_names: Tuple[str, ...] = ("data", "model")


@dataclass
class BucketConfig:
    """Static-shape buckets (XLA recompiles per shape; buckets bound that).

    No reference counterpart: the reference runs fully dynamic shapes at
    batch size 1 (reference: trainer.py:134-166).
    """

    # audio lengths in samples (16 kHz); 20 s max per the reference filter
    audio_samples: Tuple[int, ...] = (80000, 160000, 240000, 320000)
    # total LLM sequence lengths (prefix + audio embeds + suffix + response)
    seq_lens: Tuple[int, ...] = (256, 512, 768, 1024)
    max_response_tokens: int = 256
    max_text_tokens: int = 256


@dataclass
class TrainConfig:
    # reference: config/llama3_hubert.yaml train.*
    num_workers: int = 4
    batch_size: int = 8  # reference forced 1; we batch for the MXU
    grad_accum_interval: int = 1  # reference: 16 (bs=1); absorbed into batch
    epochs: int = 10
    use_ld_loss: bool = True
    use_fd_loss: bool = True
    ntp_loss_weight: float = 0.5
    ld_loss_weight: float = 0.5
    fd_loss_weight: float = 1.0
    fd_loss_connector_layers: Tuple[int, ...] = (0, 5, 11, 17, 23)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    # TPU additions
    mesh: MeshConfig = field(default_factory=MeshConfig)
    buckets: BucketConfig = field(default_factory=BucketConfig)
    remat: bool = True  # jax.checkpoint the LLM blocks
    # "full" recomputes whole blocks in backward; "save_qkv" keeps post-rope
    # q/k/v + attention outputs resident so the backward skips recomputing
    # the qkv projections, rope, and the flash forward (the frozen LLM's dx
    # chain needs no other activations from the attention half) — measured
    # on the real chip before changing the default (PERF.md).
    remat_policy: str = "full"  # "full" | "save_qkv"
    steps: Optional[int] = None  # optional hard step cap (overrides epochs)
    # Sequence parallelism for long-audio training: shard the spliced
    # sequence over the mesh "seq" axis and run the LLM forward through ring
    # attention (ops/ring_attention.py). Requires mesh.seq > 1.
    use_ring_attention: bool = False
    # Also shard the ENCODER frames over "seq": conv stem with halo
    # exchange + bidirectional ring attention (models/hubert.py SP path).
    # Requires use_ring_attention, a hubert-large-style encoder, and audio
    # buckets divisible by 320*seq.
    encoder_sp: bool = False


@dataclass
class DataConfig:
    # reference: config/llama3_hubert.yaml data.*
    base_path: str = ""
    train_set: Tuple[str, ...] = ()
    val_set: Tuple[str, ...] = ()
    # TPU additions: "synthetic" generates random fixtures (no LibriSpeech
    # download available in this environment); "hf_disk" loads preprocessed
    # HF datasets with the reference's column schema
    # (reference: preprocess_data/utils.py:121).
    source: str = "hf_disk"  # "hf_disk" | "synthetic"
    synthetic_num_samples: int = 512


@dataclass
class DebugConfig:
    """Debug toggles (no reference counterpart — SURVEY.md §5 race/NaN row)."""

    nans: bool = False  # jax_debug_nans: fail fast on NaN/Inf
    disable_jit: bool = False


@dataclass
class LogConfig:
    # reference: config/llama3_hubert.yaml log.*
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    log_interval: int = 10
    validation_interval: int = 30000
    num_generate_samples: int = 5
    # TPU additions
    jsonl_metrics: bool = True
    # Periodic checkpoint saves overlap training via Orbax async (the
    # SIGTERM/preemption save always blocks); False = save synchronously.
    async_checkpoint: bool = True


@dataclass
class Config:
    seed_everything: int = 1234  # reference: config/llama3_hubert.yaml
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    log: LogConfig = field(default_factory=LogConfig)
    debug: DebugConfig = field(default_factory=DebugConfig)


def _build(cls: Any, raw: Any, path: str) -> Any:
    """Recursively build a dataclass from nested dicts, rejecting unknown keys."""
    if raw is None:
        return cls()
    if not dataclasses.is_dataclass(cls):
        return raw
    if not isinstance(raw, dict):
        raise TypeError(f"config section '{path}' must be a mapping, got {type(raw).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(raw) - set(fields)
    if unknown:
        raise KeyError(f"unknown config key(s) {sorted(unknown)} in section '{path}'")
    kwargs = {}
    for name, value in raw.items():
        f = fields[name]
        # NOTE: with `from __future__ import annotations` f.type is always
        # a STRING, so nested dataclasses are handled exclusively through
        # the default_factory path below — there is deliberately no
        # type-object branch here (one existed, dead, implying a safety
        # net that never fired)
        sub = None
        # resolve nested dataclass types declared via default_factory
        factory = f.default_factory if f.default_factory is not dataclasses.MISSING else None  # type: ignore[misc]
        if factory is not None and dataclasses.is_dataclass(factory):
            kwargs[name] = _build(factory, value, f"{path}.{name}")
        elif sub is not None and dataclasses.is_dataclass(sub):
            kwargs[name] = _build(sub, value, f"{path}.{name}")
        elif isinstance(value, list):
            kwargs[name] = tuple(value)
        elif isinstance(value, str) and "float" in str(f.type):
            # YAML 1.1 parses "5e-5" (no dot) as a string; coerce per schema
            kwargs[name] = float(value)
        elif isinstance(value, str) and str(f.type) in ("int", "Optional[int]"):
            kwargs[name] = int(value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


def load_config(path_or_dict) -> Config:
    """Load a YAML config file (or dict) into the typed schema.

    Accepts the reference's field names verbatim (reference:
    config/llama3_hubert.yaml) and ignores the reference-only key
    ``train.num_gpus`` (device count comes from the mesh here).
    """
    if isinstance(path_or_dict, dict):
        import copy

        # deep copy: the num_gpus pop below must not mutate the CALLER's
        # nested dict (a shallow dict() shares the nested train mapping)
        raw = copy.deepcopy(path_or_dict)
    else:
        with open(path_or_dict) as f:
            raw = yaml.safe_load(f) or {}
    train = raw.get("train")
    if isinstance(train, dict):
        train.pop("num_gpus", None)  # reference-only; superseded by mesh
    return _build(Config, raw, "config")


def config_to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)
