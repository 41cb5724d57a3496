"""LLMSpeechTextInference — the product inference API (port of
``infer/engine.py``, the single-device path).

  * ``generate_text_response(_batch)``: templated text prompts;
  * ``generate_audio_response(_batch)``: audio (+ optional text) prompts,
    HuBERT or Whisper → projector (pool, stack, or ctc_pool over given
    frame ranges) → ``[prefix | mid | suffix]`` splice → decode;
  * ``iter_audio_response_batches`` / ``generate_audio_response_batches``:
    a stream of batches, pipelined one deep: batch i+1's prompt is built
    on a builder thread (on the card, on a side CUDA stream) while batch i
    prefills and decodes, with the token streams of per-batch calls.

Decoding is greedy, sampled at the engine's temperature / top-k / top-p,
sampled per request (``sampling``), or, with ``speculative_k > 0`` and a
greedy batch, self-speculative. The KV cache is ``kv_cache_dtype`` (or the
compute dtype): int8 decodes through kernel B2, bfloat16 through B3.
Batches are padded to a power of two rows, audio to 1600-sample (100 ms)
buckets, prompts to ``BUCKET``-token lengths and ``max_new_tokens`` to
``DECODE_BUCKET``, as the JAX engine does; the audio buffer length comes
from the encoder's frame arithmetic (``audio_embed_buffer_len``), HuBERT's
or Whisper's, without running it, or from the number of ranges. Weights
come from the caller, from ``cli/convert.py`` files (``model.llm_checkpoint``,
``model.encoder_checkpoint``, ``audio_encoder_checkpoint``) or from a seeded
random init.

Tensor parallelism (``mesh`` with ``model`` > 1, one process per rank of
the model group): every rank loads or initializes the full LLM, fuses and
quantizes it, keeps its shard (``parallel/sharding.py``) and drops the
rest. Rank 0 of the group builds every prompt: it alone holds the audio
encoder and the whole embedding table the prompt rows come from. The
batch path runs SPMD, every rank making the same call: rank 0 broadcasts
the prompt embeddings and mask at the start of the decode, and the ranks
decode over the sharded forward in step (``infer/generate.py``); the
prompt arguments of the other ranks' calls are not read.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional, Sequence, Union

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
    shard_config,
)
from ..models.whisper import WhisperConfig
from ..obs.profile import annotate
from ..ops.splice import concat_mid_buffers, splice_sequences
from ..parallel.comm import broadcast_call, group_rank
from ..parallel.sharding import shard_llama_params
from ..train.checkpoint import load_encoder, load_params
from ..utils.prompts import prompt_template_for
from ..utils.tokenizer import load_tokenizer
from .generate import greedy_generate, speculative_generate
from .sampling import pack_sampling_params, sampling_tensors

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}
# prompt lengths round up to BUCKET tokens (the 10 s prompt prefills at
# T=320) and max_new_tokens to DECODE_BUCKET, as in the JAX engine
BUCKET = 64
DECODE_BUCKET = 64
# the JAX engine uploads a padded batch of at least 2 * _upload_chunks
# waveforms as float16 and casts it to the compute dtype on the device, so
# its encoder sees the samples rounded through float16; the port rounds the
# same batches the same way (and uploads half the bytes)
UPLOAD_CHUNKS = 4


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_batch(n: int) -> int:
    """Batch-size bucket: next power of two."""
    b = 1
    while b < n:
        b *= 2
    return b


class LLMSpeechTextInference:
    def __init__(
        self,
        config: Config,
        audio_encoder_params=None,
        audio_encoder_checkpoint: Optional[str] = None,
        llm_params=None,
        llm_cfg: Optional[LlamaConfig] = None,
        encoder_cfg: Optional[Union[HubertConfig, WhisperConfig]] = None,
        device=None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        repetition_penalty: float = 1.0,
        mesh=None,
        speculative_k: int = 0,
        prompt_table=None,
    ):
        """``device=None`` means the CUDA card, and raises RuntimeError
        without one; pass ``device="cpu"`` for the plain path. Without given
        parameters, the engine initializes its own from two
        ``torch.Generator``s on ``device`` seeded from
        ``config.seed_everything`` (LLM, then encoder), or loads
        ``model.llm_checkpoint`` (a ``cli/convert.py llm`` file) for the LLM
        and ``audio_encoder_checkpoint`` (else ``model.encoder_checkpoint``:
        a ``cli/convert.py encoder`` file or an ``export_encoder`` one) for
        the encoder, cast to ``param_dtype``; when ``llm_weight_dtype`` is
        int8 it fuses and quantizes the LLM it owns (initialized or loaded).
        Caller-given trees are used as they are (under a mesh: full trees,
        which the engine shards, or, with ``prompt_table``, this rank's
        shard already, as the trainer holds it; ``prompt_table`` is then
        the whole embedding table and its scale). ``llm_cfg`` and
        ``encoder_cfg`` override the presets the config names.
        ``speculative_k > 0`` decodes greedy batches self-speculatively (not
        with a repetition penalty or a temperature). ``mesh``: a
        ``parallel.mesh.Mesh`` whose model group shares the LLM (see the
        module docstring; the engine runs on that one group, whatever the
        mesh's data and seq axes); a model width its size does not divide
        raises ValueError."""
        if prompt_table is not None and llm_params is None:
            raise ValueError("prompt_table comes with the llm_params shard it belongs to")
        self.mesh = mesh
        self.tp = mesh.model if mesh is not None else 1
        self.tp_group = mesh.model_group if mesh is not None else None
        # rank 0 of the model group builds the prompts (encoder, prompt rows)
        self.builds_prompts = group_rank(self.tp_group) == 0
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
        # the engine ran; "decode_issue_s" (``greedy_generate``), and
        # "prompt_wait_s" and "pipeline_batches" (``iter_audio_response_
        # batches``): host seconds; prompt builders on other threads count
        # under the lock
        self.counts: Counter = Counter()
        self._counts_lock = threading.Lock()
        self._side_stream = None  # the pipelined batches' builder stream (cuda)

        self.llm_cfg = llm_cfg or llama_preset(config.model.llm_preset or config.model.llm_type)
        shard_config(self.llm_cfg, self.tp)
        if llm_params is None:
            if config.model.llm_checkpoint:
                llm_params = load_params(config.model.llm_checkpoint, self.device,
                                         param_dtype)["llm_params"]
            else:
                gen = torch.Generator(device=self.device).manual_seed(config.seed_everything)
                llm_params = init_llama_params(gen, self.llm_cfg, dtype=param_dtype,
                                               device=self.device)
            if config.model.llm_weight_dtype == "int8":
                llm_params = quantize_llama_params(fuse_llama_params(llm_params))
        # the (V, D) table and its per-row scale the prompt rows come from
        given_shard = prompt_table is not None
        if not given_shard:
            prompt_table = (llm_params["embed_tokens"], llm_params.get("embed_tokens_scale"))
        self._prompt_table = prompt_table if self.builds_prompts else None
        if self.tp > 1 and not given_shard:
            llm_params = shard_llama_params(llm_params, self.llm_cfg, group_rank(self.tp_group),
                                            self.tp)
        self.llm_params = llm_params

        self.encoder_setup = encoder_setup_from_config(config)
        if encoder_cfg is not None:
            self.encoder_setup = dataclasses.replace(self.encoder_setup, encoder_cfg=encoder_cfg)
        audio_encoder_checkpoint = audio_encoder_checkpoint or config.model.encoder_checkpoint
        if not self.builds_prompts:
            audio_encoder_params = None
        elif audio_encoder_checkpoint:
            audio_encoder_params = load_encoder(audio_encoder_checkpoint, self.device,
                                                param_dtype)
        elif audio_encoder_params is None:
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
        t, scale = self._prompt_table
        ids = ids.long()
        e = t[ids].to(self.dtype)
        if t.dtype == torch.int8:
            e = e * scale[ids][..., None].to(self.dtype)
        return e

    def _generate_from_embeds(self, embeds, attn_mask, max_new_tokens: int,
                              sampling=None) -> List[str]:
        """Prefill + decode, then detokenize. ``sampling``: optional
        per-request ``[(temperature, top_k, top_p, seed) | None, ...]``
        (length = real batch; padded rows greedy). Under a model group,
        rank 0's ``embeds`` and ``attn_mask`` reach every rank (the others
        pass None)."""
        if self.tp > 1:
            _, (embeds, attn_mask) = broadcast_call(
                None, [embeds, attn_mask] if self.builds_prompts else None, self.tp_group,
                device=self.device)
        packed = pack_sampling_params(sampling, embeds.shape[0])
        bucket = _round_up(max_new_tokens, DECODE_BUCKET)
        common = dict(eos_id=self.tokenizer.eos_id, cache_dtype=self.cache_dtype,
                      num_steps=max_new_tokens, counts=self.counts, tp_group=self.tp_group)
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
        with annotate("lss.batch.detokenize"):
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
        """Templated text prompts → left-padded (B, L, D) embeds + mask;
        (None, None) on a rank of a model group that builds no prompts."""
        if not self.builds_prompts:
            return None, None
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
        self,
        audio: np.ndarray,
        additional_text_prompt: str = "",
        max_new_tokens: int = 256,
        ctc_pool_ranges: Optional[np.ndarray] = None,
    ) -> str:
        return self.generate_audio_response_batch(
            [audio], additional_text_prompt=additional_text_prompt,
            max_new_tokens=max_new_tokens,
            ctc_pool_ranges=None if ctc_pool_ranges is None else [ctc_pool_ranges],
        )[0]

    @torch.no_grad()
    def generate_audio_response_batch(
        self,
        audios: Sequence[np.ndarray],
        additional_text_prompt: str = "",
        max_new_tokens: int = 256,
        ctc_pool_ranges: Optional[Sequence[np.ndarray]] = None,
        sampling=None,
    ) -> List[str]:
        """Audio(+text)-prompted generation, batched over utterances of
        different lengths; ``ctc_pool_ranges``: one (G_i, 2) array of
        [start, end) frame ranges per clip, for a ``ctc_pool`` projector."""
        if not audios:
            return []
        embeds, mask = self.build_audio_prompt_batch(audios, additional_text_prompt,
                                                     ctc_pool_ranges)
        return self._generate_from_embeds(embeds, mask, max_new_tokens, sampling)[: len(audios)]

    def generate_audio_response_batches(
        self,
        batches: Iterable[Sequence[np.ndarray]],
        additional_text_prompt: str = "",
        max_new_tokens: int = 256,
        sampling: Optional[Iterable] = None,  # per batch, aligned with batches
        ctc_pool_ranges: Optional[Iterable] = None,  # per batch, ditto
    ) -> List[List[str]]:
        """Bulk audio generation over a stream of batches, pipelined one
        batch deep (``iter_audio_response_batches``): each batch's token
        streams equal a ``generate_audio_response_batch`` call on it."""
        return list(self.iter_audio_response_batches(
            batches, additional_text_prompt=additional_text_prompt,
            max_new_tokens=max_new_tokens, sampling=sampling, ctc_pool_ranges=ctc_pool_ranges))

    def iter_audio_response_batches(
        self,
        batches: Iterable[Sequence[np.ndarray]],
        additional_text_prompt: str = "",
        max_new_tokens: int = 256,
        sampling: Optional[Iterable] = None,  # per batch, aligned with batches
        ctc_pool_ranges: Optional[Iterable] = None,  # per batch, ditto
    ) -> Iterator[List[str]]:
        """Yield each batch's responses as it completes. While batch i
        prefills and decodes, a builder thread builds batch i+1's prompt
        (padding, float16 rounding, pinned copy and upload, encoder,
        splice); on the card it does so on a side CUDA stream, and the
        decode's stream waits on an event recorded after the splice. At most
        two batches of audio are held (the one decoding and the one being
        built), so ``batches`` may be a lazy generator over a corpus. The
        per-batch ``sampling`` and ``ctc_pool_ranges`` iterators are drawn
        in step with ``batches``; one that runs short raises ValueError.
        ``counts`` gains "pipeline_batches", the batches taken from the
        builder, and "prompt_wait_s", the host seconds this thread waited
        for them (span ``lss.batch.wait_prompt``)."""
        samp_it = iter(sampling) if sampling is not None else None
        ranges_it = iter(ctc_pool_ranges) if ctc_pool_ranges is not None else None
        cuda = self.device.type == "cuda"
        if cuda and self._side_stream is None:
            self._side_stream = torch.cuda.Stream(device=self.device)

        def staged(batch, after):
            """(batch length, sampling, embeds, mask, ready event) for one
            batch, on the builder thread; on the card the side stream first
            waits for ``after``, the main stream's work enqueued before the
            build was submitted (the parameters' writes among it)."""
            try:
                s = next(samp_it) if samp_it is not None else None
                r = next(ranges_it) if ranges_it is not None else None
            except StopIteration:
                raise ValueError("sampling / ctc_pool_ranges ran out before batches did "
                                 "(they must align per batch)") from None
            if not cuda:
                return (len(batch), s, *self.build_audio_prompt_batch(
                    batch, additional_text_prompt, ctc_pool_ranges=r), None)
            self._side_stream.wait_event(after)
            with torch.cuda.stream(self._side_stream):
                embeds, mask = self.build_audio_prompt_batch(batch, additional_text_prompt,
                                                             ctc_pool_ranges=r)
                ready = torch.cuda.Event()
                ready.record(self._side_stream)
            return len(batch), s, embeds, mask, ready

        def submit(ex, batch):
            after = None
            if cuda:
                after = torch.cuda.Event()
                after.record(torch.cuda.current_stream(self.device))
            return ex.submit(staged, batch, after)

        it = iter(batches)
        end = object()
        with ThreadPoolExecutor(max_workers=1) as ex:
            nxt = next(it, end)
            if nxt is end:
                return
            fut = submit(ex, nxt)
            while True:
                waited = time.perf_counter()
                with annotate("lss.batch.wait_prompt"):
                    n_real, s, embeds, mask, ready = fut.result()
                    if ready is not None and embeds is not None:
                        main = torch.cuda.current_stream(self.device)
                        main.wait_event(ready)
                        # made on the side stream, read and freed on this one
                        embeds.record_stream(main)
                        mask.record_stream(main)
                self.counts["prompt_wait_s"] += time.perf_counter() - waited
                self.counts["pipeline_batches"] += 1
                nxt = next(it, end)
                if nxt is not end:
                    fut = submit(ex, nxt)
                with torch.no_grad():
                    out = self._generate_from_embeds(embeds, mask, max_new_tokens, s)[:n_real]
                del embeds, mask
                yield out
                if nxt is end:
                    return

    def _upload_wav(self, wav: np.ndarray) -> torch.Tensor:
        """The padded (B, N) float32 waveforms on the device in the compute
        dtype. A batch of ``2 * UPLOAD_CHUNKS`` rows or more is rounded
        through float16 first, as the JAX engine uploads it (with or without
        ranges); on the card the host copy is pinned and the upload does not
        block the host."""
        if wav.shape[0] >= 2 * UPLOAD_CHUNKS:
            wav = wav.astype(np.float16)
        host = torch.from_numpy(wav)
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True).to(self.dtype)
        return host.to(self.device).to(self.dtype)

    @torch.no_grad()
    def build_audio_prompt_batch(
        self,
        audios: Sequence[np.ndarray],
        additional_text_prompt: str = "",
        ctc_pool_ranges: Optional[Sequence[np.ndarray]] = None,
    ):
        """Audio(+text) prompts → spliced left-padded (B, L, D) embeds +
        mask, B power-of-two padded, L bucket-rounded. A ``ctc_pool``
        projector needs ``ctc_pool_ranges`` (one (G_i, 2) array per clip,
        zero-padded to the longest; padded rows get none, so no valid
        embedding); other projectors ignore them. (None, None) on a rank of
        a model group that builds no prompts. Spans: ``lss.prompt.host``
        (padding, float16 rounding, pinning, the upload's issue),
        ``lss.prompt.encoder`` and ``lss.prompt.splice``."""
        if not self.builds_prompts:
            return None, None
        with annotate("lss.prompt.host"):
            n_real = len(audios)
            B = _pad_batch(n_real)
            audios = list(audios) + [audios[0]] * (B - n_real)
            lens = np.array([len(a) for a in audios], np.int32)
            N = _round_up(int(lens.max()), 1600)  # 100 ms audio buckets
            wav = np.zeros((B, N), np.float32)
            for b, a in enumerate(audios):
                wav[b, : len(a)] = a

            dev = self.device
            ranges = None
            if self.encoder_setup.downsample_method == "ctc_pool":
                if ctc_pool_ranges is None:
                    raise ValueError("the ctc_pool projector needs ctc_pool_ranges")
                G = max(np.asarray(r).reshape(-1, 2).shape[0] for r in ctc_pool_ranges)
                ranges_np = np.zeros((B, G, 2), np.int32)
                for b, r in enumerate(ctc_pool_ranges):
                    r = np.asarray(r, np.int32).reshape(-1, 2)
                    ranges_np[b, : r.shape[0]] = r
                ranges = torch.from_numpy(ranges_np).to(dev)

            if additional_text_prompt:
                # BOS-stripped, placed BEFORE the audio (reference: inference.py:113-122)
                txt_row = self.tokenizer.encode(additional_text_prompt, add_bos=False)
                txt_ids = torch.tensor([txt_row] * B, dtype=torch.int32, device=dev)
            else:
                txt_ids = torch.zeros((B, 0), dtype=torch.int32, device=dev)
            txt_lens = torch.full((B,), txt_ids.shape[1], dtype=torch.int32, device=dev)

            M = audio_embed_buffer_len(self.encoder_setup, N,
                                       None if ranges is None else ranges.shape[1])
            P, S = self.prefix_ids.shape[0], self.suffix_ids.shape[0]
            total_len = _round_up(P + M + txt_ids.shape[1] + S, BUCKET)

            wav_t = self._upload_wav(wav)
            lens_t = torch.from_numpy(lens).to(dev)
        with annotate("lss.prompt.encoder"):
            audio_embeds, emb_lens = audio_encoder_forward(
                self.audio_encoder_params, self.encoder_setup, wav_t, lens_t,
                ctc_pool_ranges=ranges)
        with self._counts_lock:
            self.counts["encoder_forwards"] += 1
        with annotate("lss.prompt.splice"):
            return self._splice(audio_embeds, emb_lens, txt_ids, txt_lens, total_len)
