"""Models: the port of ``llm_speech_summarization_tpu.models``."""

from .audio_encoder import (
    AudioEncoder,
    AudioEncoderParams,
    audio_encoder_forward,
    init_audio_encoder,
)
from .hubert import HubertConfig, hubert_forward, hubert_preset, init_hubert_params
from .llama import (
    KVCache,
    LlamaConfig,
    LlamaOutput,
    init_llama_params,
    llama_forward,
    llama_preset,
)
from .whisper import WhisperConfig, init_whisper_params, whisper_forward, whisper_preset

__all__ = [
    "KVCache",
    "LlamaConfig",
    "LlamaOutput",
    "init_llama_params",
    "llama_forward",
    "llama_preset",
    "HubertConfig",
    "hubert_forward",
    "hubert_preset",
    "init_hubert_params",
    "WhisperConfig",
    "init_whisper_params",
    "whisper_forward",
    "whisper_preset",
    "AudioEncoder",
    "AudioEncoderParams",
    "audio_encoder_forward",
    "init_audio_encoder",
]
