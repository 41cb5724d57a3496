"""Chat-prompt templates and the audio-embedding length calculus.

Semantics match the reference exactly so token streams are comparable:
  * templates: reference utils.py:6-10 (duplicated preprocess_data/utils.py:6-10)
  * compute_num_audio_embeds: reference utils.py:13-24
  * template selection by exact llm_type match: reference utils.py:50-57
"""

from __future__ import annotations

from dataclasses import dataclass

SYSTEM_PROMPT = ""
MINICHAT_PROMPT_PREFIX = f"{SYSTEM_PROMPT}[|User|]"
MINICHAT_PROMPT_SUFFIX = "</s>[|Assistant|]"
LLAMA_PROMPT_PREFIX = (
    f"<|start_header_id|>system<|end_header_id|>{SYSTEM_PROMPT}<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n"
)
LLAMA_PROMPT_SUFFIX = "<|eot_id|><|start_header_id|>assistant<|end_header_id|>\n\n"
# Moonlight-16B-A3B-Instruct's chat markers (its tokenizer_config chat template)
MOONLIGHT_PROMPT_PREFIX = f"{SYSTEM_PROMPT}<|im_user|>user<|im_middle|>"
MOONLIGHT_PROMPT_SUFFIX = "<|im_end|><|im_assistant|>assistant<|im_middle|>"


@dataclass(frozen=True)
class PromptTemplate:
    prefix: str
    suffix: str

    def full_text_prompt(self, text: str) -> str:
        # reference: inference.py:78 — f"{prefix} {text}{suffix} "
        return f"{self.prefix} {text}{self.suffix} "


_TEMPLATES = {
    "GeneZC/MiniChat-2-3B": PromptTemplate(MINICHAT_PROMPT_PREFIX, MINICHAT_PROMPT_SUFFIX),
    "meta-llama/Llama-3.2-3B-Instruct": PromptTemplate(LLAMA_PROMPT_PREFIX, LLAMA_PROMPT_SUFFIX),
    "moonshotai/Moonlight-16B-A3B": PromptTemplate(MOONLIGHT_PROMPT_PREFIX,
                                                   MOONLIGHT_PROMPT_SUFFIX),
}


def prompt_template_for(llm_type: str) -> PromptTemplate:
    """Select the chat template for an LLM type.

    Exact-match like the reference's training path (reference: utils.py:50-57),
    with the inference path's substring fallback ("llama" in llm_type →
    Llama template, else MiniChat; reference: inference.py:39-44) applied for
    unknown types instead of raising, so custom fine-tunes keep working.
    """
    if llm_type in _TEMPLATES:
        return _TEMPLATES[llm_type]
    if "llama" in llm_type.lower():
        return _TEMPLATES["meta-llama/Llama-3.2-3B-Instruct"]
    return _TEMPLATES["GeneZC/MiniChat-2-3B"]


def compute_num_audio_embeds(audio_samples: int, sr: int = 16000, downsample_factor: int = 4) -> int:
    """Number of audio embeddings produced for a waveform of given length.

    Mirrors reference utils.py:13-24: the pretrained HuBERT/Whisper stack emits
    one frame per 20 ms (after a 10 ms edge loss), and the projector pools by
    `downsample_factor` with one further frame dropped (the reference's
    documented off-by-one tolerance).
    """
    num_embeds = (audio_samples - (sr * 0.01)) // (sr * 0.02)
    return int(num_embeds // downsample_factor - 1)
