"""LLMSpeechTextInference — the product inference API (port of
``infer/engine.py``, the single-device path).

  * ``generate_text_response(_batch)``: templated text prompts;
  * ``generate_audio_response(_batch)``: audio (+ optional text) prompts,
    HuBERT → projector → ``[prefix | mid | suffix]`` splice → decode;
  * ``generate_audio_response_batches``: a stream of batches, run one after
    another (the JAX engine's one-deep upload pipeline is later work).

Decoding is greedy, sampled at the engine's temperature / top-k / top-p,
sampled per request (``sampling``), or, with ``speculative_k > 0`` and a
greedy batch, self-speculative. Batches are padded to a power of two rows,
audio to 1600-sample (100 ms) buckets, prompts to ``BUCKET``-token lengths
and ``max_new_tokens`` to ``DECODE_BUCKET``, as the JAX engine does. Not
ported yet: meshes (tensor parallel serving), checkpoint loading, the
Whisper encoder and the ctc_pool projector.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs import Config
from ..device import resolve_device
from ..models.audio_encoder import (
    audio_embed_buffer_len,
    audio_encoder_forward,
    encoder_setup_from_config,
    init_audio_encoder,
)
from ..models.hubert import HubertConfig
from ..models.llama import (
    LlamaConfig,
    fuse_llama_params,
    init_llama_params,
    llama_preset,
    quantize_llama_params,
)
from ..ops.splice import concat_mid_buffers, splice_sequences
from ..utils.prompts import prompt_template_for
from ..utils.tokenizer import load_tokenizer
from .generate import greedy_generate, speculative_generate
from .sampling import pack_sampling_params, sampling_tensors

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}
# prompt lengths round up to BUCKET tokens (the 10 s prompt prefills at
# T=320) and max_new_tokens to DECODE_BUCKET, as in the JAX engine
BUCKET = 64
DECODE_BUCKET = 64


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_batch(n: int) -> int:
    """Batch-size bucket: next power of two."""
    b = 1
    while b < n:
        b *= 2
    return b


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP queue A, {item})")


class LLMSpeechTextInference:
    def __init__(
        self,
        config: Config,
        audio_encoder_params=None,
        llm_params=None,
        llm_cfg: Optional[LlamaConfig] = None,
        encoder_cfg: Optional[HubertConfig] = None,
        device=None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        repetition_penalty: float = 1.0,
        mesh=None,
        speculative_k: int = 0,
    ):
        """``device=None`` means the CUDA card, and raises RuntimeError
        without one; pass ``device="cpu"`` for the plain path. Without given
        parameters, the engine initializes its own from two
        ``torch.Generator``s on ``device`` seeded from
        ``config.seed_everything`` (LLM, then encoder) and, when
        ``llm_weight_dtype`` is int8, fuses and quantizes the LLM it owns;
        caller-given trees are used as they are. ``llm_cfg`` and
        ``encoder_cfg`` override the presets the config names.
        ``speculative_k > 0`` decodes greedy batches self-speculatively
        (not with a repetition penalty or a temperature)."""
        if mesh is not None:
            raise _not_ported("tensor-parallel serving (mesh)", "item 11")
        if config.model.llm_checkpoint or config.model.encoder_checkpoint:
            raise _not_ported("checkpoint loading", "item 12")
        self.config = config
        self.device = resolve_device(device)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.repetition_penalty = repetition_penalty
        self.speculative_k = speculative_k
        # draws of the engine-wide temperature (per-request sampling keys
        # its own counter hash instead)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed_everything)
        self.dtype = _DTYPES[config.model.compute_dtype]
        self.cache_dtype = _DTYPES[config.model.kv_cache_dtype or config.model.compute_dtype]
        param_dtype = _DTYPES[config.model.param_dtype]
        # "encoder_forwards", "prefills", "decode_steps", "spec_rounds": what
        # the engine ran
        self.counts: Counter = Counter()

        self.llm_cfg = llm_cfg or llama_preset(config.model.llm_preset or config.model.llm_type)
        if llm_params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed_everything)
            llm_params = init_llama_params(gen, self.llm_cfg, dtype=param_dtype, device=self.device)
            if config.model.llm_weight_dtype == "int8":
                llm_params = quantize_llama_params(fuse_llama_params(llm_params))
        self.llm_params = llm_params

        self.encoder_setup = encoder_setup_from_config(config)
        if encoder_cfg is not None:
            self.encoder_setup = dataclasses.replace(self.encoder_setup, encoder_cfg=encoder_cfg)
        if audio_encoder_params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed_everything + 1)
            audio_encoder_params = init_audio_encoder(
                gen, self.encoder_setup, dtype=param_dtype, device=self.device
            )
        self.audio_encoder_params = audio_encoder_params

        self.llm_type = config.model.llm_type
        self.tokenizer = load_tokenizer(self.llm_type, config.model.tokenizer_path)
        self.template = prompt_template_for(self.llm_type)
        self.prefix_ids = torch.tensor(
            self.tokenizer.encode(self.template.prefix, add_bos=True), dtype=torch.int32,
            device=self.device,
        )
        self.suffix_ids = torch.tensor(  # BOS-stripped (reference: utils.py:70-71)
            self.tokenizer.encode(self.template.suffix, add_bos=False), dtype=torch.int32,
            device=self.device,
        )

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _embed_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings; an int8 table is gathered at int8 width and
        dequantized per row, never materialized whole."""
        t = self.llm_params["embed_tokens"]
        ids = ids.long()
        e = t[ids].to(self.dtype)
        if t.dtype == torch.int8:
            e = e * self.llm_params["embed_tokens_scale"][ids][..., None].to(self.dtype)
        return e

    def _generate_from_embeds(self, embeds, attn_mask, max_new_tokens: int,
                              sampling=None) -> List[str]:
        """Prefill + decode, then detokenize. ``sampling``: optional
        per-request ``[(temperature, top_k, top_p, seed) | None, ...]``
        (length = real batch; padded rows greedy)."""
        packed = pack_sampling_params(sampling, embeds.shape[0])
        bucket = _round_up(max_new_tokens, DECODE_BUCKET)
        common = dict(eos_id=self.tokenizer.eos_id, cache_dtype=self.cache_dtype,
                      num_steps=max_new_tokens, counts=self.counts)
        if (packed is None and self.speculative_k > 0 and self.temperature <= 0.0
                and self.repetition_penalty == 1.0):
            tokens, lens, _ = speculative_generate(
                self.llm_params, self.llm_cfg, embeds.to(self.dtype), attn_mask,
                max_new_tokens=bucket, k=self.speculative_k, **common)
        else:
            tokens, lens = greedy_generate(
                self.llm_params,
                self.llm_cfg,
                embeds.to(self.dtype),
                attn_mask,
                max_new_tokens=bucket,
                temperature=self.temperature,
                top_k=self.top_k,
                top_p=self.top_p,
                repetition_penalty=self.repetition_penalty,
                generator=self.generator,
                sampling=None if packed is None else sampling_tensors(packed, self.device),
                **common,
            )
        tokens = tokens.cpu().numpy()
        lens = lens.cpu().numpy()
        return [
            self.tokenizer.decode(row[: min(int(n), max_new_tokens)].tolist(),
                                  skip_special_tokens=True)
            for row, n in zip(tokens, lens)
        ]

    def _splice(self, audio_embeds, emb_lens, txt_ids, txt_lens, total_len: int):
        """Optional text embeds + mid-buffer concat, then the [prefix | mid
        | suffix] splice over a (P+S, D) mini-table of exactly the
        template's (dequantized) rows."""
        P, S = self.prefix_ids.shape[0], self.suffix_ids.shape[0]
        if txt_ids.shape[1] > 0:
            mid, mid_lens = concat_mid_buffers(
                self._embed_rows(txt_ids), txt_lens, audio_embeds.to(self.dtype), emb_lens
            )
        else:
            mid, mid_lens = audio_embeds.to(self.dtype), emb_lens
        mini = self._embed_rows(torch.cat([self.prefix_ids, self.suffix_ids]))
        dev = self.device
        sp = splice_sequences(
            mini,
            torch.arange(P, dtype=torch.int32, device=dev),
            torch.arange(P, P + S, dtype=torch.int32, device=dev),
            mid, mid_lens, total_len=total_len,
        )
        return sp.embeds, sp.attn_mask

    # ------------------------------------------------------------------
    # public API (reference parity)
    # ------------------------------------------------------------------

    def generate_text_response(self, input_text: str, max_new_tokens: int = 256) -> str:
        return self.generate_text_response_batch([input_text], max_new_tokens)[0]

    def build_text_prompt_batch(self, input_texts: Sequence[str]):
        """Templated text prompts → left-padded (B, L, D) embeds + mask."""
        n_real = len(input_texts)
        ids_list = [
            self.tokenizer.encode(self.template.full_text_prompt(t), add_bos=True)
            for t in input_texts
        ]
        L = _round_up(max(len(i) for i in ids_list), BUCKET)
        B = _pad_batch(n_real)
        ids_list = ids_list + [ids_list[0]] * (B - n_real)
        ids = np.zeros((B, L), np.int32)
        mask = np.zeros((B, L), bool)
        for b, row in enumerate(ids_list):  # left padding
            ids[b, L - len(row):] = row
            mask[b, L - len(row):] = True
        ids_t = torch.from_numpy(ids).to(self.device)
        mask_t = torch.from_numpy(mask).to(self.device)
        return self._embed_rows(ids_t) * mask_t[..., None].to(self.dtype), mask_t

    @torch.no_grad()
    def generate_text_response_batch(
        self, input_texts: Sequence[str], max_new_tokens: int = 256, sampling=None
    ) -> List[str]:
        if not input_texts:
            return []
        embeds, mask = self.build_text_prompt_batch(input_texts)
        return self._generate_from_embeds(embeds, mask, max_new_tokens,
                                          sampling)[: len(input_texts)]

    def generate_audio_response(
        self, audio: np.ndarray, additional_text_prompt: str = "", max_new_tokens: int = 256
    ) -> str:
        return self.generate_audio_response_batch(
            [audio], additional_text_prompt=additional_text_prompt, max_new_tokens=max_new_tokens
        )[0]

    @torch.no_grad()
    def generate_audio_response_batch(
        self,
        audios: Sequence[np.ndarray],
        additional_text_prompt: str = "",
        max_new_tokens: int = 256,
        sampling=None,
    ) -> List[str]:
        """Audio(+text)-prompted generation, batched over utterances of
        different lengths."""
        if not audios:
            return []
        embeds, mask = self.build_audio_prompt_batch(audios, additional_text_prompt)
        return self._generate_from_embeds(embeds, mask, max_new_tokens, sampling)[: len(audios)]

    def generate_audio_response_batches(
        self,
        batches: Sequence[Sequence[np.ndarray]],
        additional_text_prompt: str = "",
        max_new_tokens: int = 256,
        sampling: Optional[Sequence] = None,  # per batch, aligned with batches
    ) -> List[List[str]]:
        """Bulk audio generation over a stream of batches, one after
        another."""
        samplings = list(sampling) if sampling is not None else [None] * len(batches)
        return [
            self.generate_audio_response_batch(batch, additional_text_prompt, max_new_tokens, s)
            for batch, s in zip(batches, samplings)
        ]

    @torch.no_grad()
    def build_audio_prompt_batch(
        self, audios: Sequence[np.ndarray], additional_text_prompt: str = ""
    ):
        """Audio(+text) prompts → spliced left-padded (B, L, D) embeds +
        mask, B power-of-two padded, L bucket-rounded."""
        n_real = len(audios)
        B = _pad_batch(n_real)
        audios = list(audios) + [audios[0]] * (B - n_real)
        lens = np.array([len(a) for a in audios], np.int32)
        N = _round_up(int(lens.max()), 1600)  # 100 ms audio buckets
        wav = np.zeros((B, N), np.float32)
        for b, a in enumerate(audios):
            wav[b, : len(a)] = a

        dev = self.device
        if additional_text_prompt:
            # BOS-stripped, placed BEFORE the audio (reference: inference.py:113-122)
            txt_row = self.tokenizer.encode(additional_text_prompt, add_bos=False)
            txt_ids = torch.tensor([txt_row] * B, dtype=torch.int32, device=dev)
        else:
            txt_ids = torch.zeros((B, 0), dtype=torch.int32, device=dev)
        txt_lens = torch.full((B,), txt_ids.shape[1], dtype=torch.int32, device=dev)

        M = audio_embed_buffer_len(self.encoder_setup, N)
        P, S = self.prefix_ids.shape[0], self.suffix_ids.shape[0]
        total_len = _round_up(P + M + txt_ids.shape[1] + S, BUCKET)

        wav_t = torch.from_numpy(wav).to(dev).to(self.dtype)
        lens_t = torch.from_numpy(lens).to(dev)
        audio_embeds, emb_lens = audio_encoder_forward(
            self.audio_encoder_params, self.encoder_setup, wav_t, lens_t
        )
        self.counts["encoder_forwards"] += 1
        return self._splice(audio_embeds, emb_lens, txt_ids, txt_lens, total_len)
