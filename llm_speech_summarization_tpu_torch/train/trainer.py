"""Trainer: the KD training loop (port of ``train/trainer.py``).

Init seeds every host RNG and a ``torch.Generator`` per model, builds the
frozen LLM (random, or ``model.llm_checkpoint``, a ``cli/convert.py llm``
file; int8 weight-only when ``llm_weight_dtype`` is int8, in the unfused
training layout) and the trainable float32 encoder (HuBERT or Whisper,
always initialized: ``model.encoder_checkpoint`` raises, as the JAX trainer
never reads it), the datasets,
the optimizer and the state, and resumes from the latest checkpoint of the
run (or a given one). ``train()`` runs epochs of collated, bucketed batches
with interval logging and validation, a step cap (``train.steps``), a
checkpoint on SIGTERM, exact resume (``epoch_step``), and a profiler
trace window (``LSS_PROFILE_DIR``, ``LSS_PROFILE_STEPS``). ``validate()``
computes the token-weighted audio and text perplexities, samples
generations through ``LLMSpeechTextInference`` and checkpoints.

One card per process. A multi-process run is one process per rank of a
(data, seq, model) mesh, launched by ``torch.distributed.run``
(``cli/train.py --mesh D,S,M``). Every rank builds the same weights from
the seed; rank 0 writes the logs and checkpoints (a barrier follows each
save, and every rank resumes from the checkpoint rank 0 picked).

  * data (``mesh.data`` > 1): each data rank draws a disjoint strided shard
    of the seeded epoch order, equal shards with the remainder dropped, as
    the JAX trainer's processes do, and collates its rows of each global
    batch (``batch_size`` / D); the ranks agree on the largest audio bucket
    of the global batch before the step. The step sums the gradients over
    the data group against global loss denominators, and ``AdamW`` keeps
    ZeRO-1 slices of its state; a checkpoint holds the whole state,
    gathered before rank 0 writes it, and loading slices it for the
    loading run's mesh. Validation batches are the global ones, padded to
    a multiple of D with zero-token rows (``pad_batch_rows``) and sharded,
    the NLL and token sums added over the data group;
  * seq (``mesh.seq`` > 1 with ``train.use_ring_attention``, optionally
    ``train.encoder_sp``: the long-audio configuration): the train and eval
    steps run over the seq group's ring;
  * model (``mesh.model`` > 1): every rank keeps its shard of the frozen
    int8 LLM (``shard_llama_params`` on the unfused tree) and the steps run
    over the model group; the encoder is whole on every rank.
Rank 0's model group (data and seq rank 0) samples the validation
generations through the engine over that group. A ``ctc_pool`` projector
takes each example's ``pool_ranges_4`` (collated to a fixed
``max_pool_ranges`` per run, which is then the audio buffer's length in
the splice).
"""

from __future__ import annotations

import contextlib
import os
import random
import signal
import time
from collections import Counter
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import Config
from ..data.batch import Batch
from ..data.collate import collate_batch
from ..data.datasets import load_training_datasets
from ..device import resolve_device
from ..models.audio_encoder import (
    audio_embed_buffer_len,
    encoder_setup_from_config,
    init_audio_encoder,
)
from ..models.llama import init_llama_params, llama_preset, quantize_llama_params
from ..models.mla_moe import is_mla_moe, mla_moe_preset, not_ported
from ..obs.profile import trace
from ..obs.writer import MetricsWriter
from ..parallel.comm import all_reduce, any_rank, max_over_ranks
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.sharding import shard_batch, shard_llama_params
from ..utils.prompts import prompt_template_for
from ..utils.tokenizer import load_tokenizer
from . import checkpoint as ckpt
from .state import TrainState, lr_at, make_train_state
from .step import _DTYPES, make_eval_step, make_train_step


def _check_parallel(cfg: Config, mesh: Mesh) -> None:
    """The sequence axis runs through ring attention, as in the JAX
    package; ``encoder_sp`` takes effect with it. The data ranks draw equal
    shares of every batch, as the JAX trainer's processes do."""
    if cfg.train.use_ring_attention and mesh.seq == 1:
        raise ValueError("use_ring_attention needs a mesh with a seq axis (mesh.seq > 1)")
    if mesh.seq > 1 and not cfg.train.use_ring_attention:
        raise NotImplementedError(
            "mesh.seq > 1 shards the spliced sequence through ring attention; set "
            "train.use_ring_attention (sequence sharding without it is not ported)")
    if cfg.train.batch_size % mesh.data:
        raise ValueError(f"batch_size={cfg.train.batch_size} does not divide over "
                         f"data={mesh.data} ranks (each draws an equal share of a batch)")


def max_pool_ranges(config: Config, enc_setup) -> Optional[int]:
    """The ranges a ``ctc_pool`` batch holds per row (None for the other
    projectors): the 4-frame ranges of the largest audio bucket, plus 8,
    as the JAX trainer collates them."""
    if enc_setup.downsample_method != "ctc_pool":
        return None
    return max(config.train.buckets.audio_samples) // 320 // 4 + 8


def spliced_length(config: Config, enc_setup, n_prefix: int, n_suffix: int,
                   audio_bucket: int) -> int:
    """The one length of the student and teacher sequences for an audio
    bucket: prefix + max(audio embeds, text cap) + suffix + response cap,
    rounded up to 128."""
    M = audio_embed_buffer_len(enc_setup, audio_bucket, max_pool_ranges(config, enc_setup))
    R = config.train.buckets.max_response_tokens
    T = config.train.buckets.max_text_tokens
    return ((n_prefix + max(M, T) + n_suffix + R + 127) // 128) * 128


class Trainer:
    def __init__(self, config: Config, run_name: str = "run",
                 checkpoint_path: Optional[str] = None, device=None,
                 mesh: Optional[Mesh] = None):
        """``device=None`` is the CUDA card and raises without one; the CPU
        runs only with ``device="cpu"``. ``mesh``: this rank's mesh, by
        default ``make_mesh(config)`` over the initialized process group."""
        self.mesh = mesh if mesh is not None else make_mesh(config)
        _check_parallel(config, self.mesh)
        # the seq group of the ring; None trains unsharded
        self.group = self.mesh.seq_group if config.train.use_ring_attention else None
        # every rank of a multi-process run (stop flags, checkpoint choice)
        self.world = (dist.group.WORLD if dist.is_initialized() and dist.get_world_size() > 1
                      else None)
        if config.model.encoder_checkpoint:
            raise ValueError(
                "model.encoder_checkpoint is an inference setting: the trainer always "
                "initializes the encoder from the seed, as the JAX trainer does (it never reads "
                "the field); unset it, or resume a run from its own checkpoint")
        self.config = config
        self.run_name = run_name
        self.device = resolve_device(device)

        seed = config.seed_everything
        random.seed(seed)
        np.random.seed(seed)

        self.checkpoint_dir = os.path.join(config.log.checkpoint_dir, run_name)
        self.log_dir = os.path.join(config.log.log_dir, run_name)
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        os.makedirs(self.log_dir, exist_ok=True)
        # rank 0 writes the logs
        self.writer = (MetricsWriter(self.log_dir, jsonl=config.log.jsonl_metrics)
                       if self.mesh.is_main else None)

        self.tokenizer = load_tokenizer(config.model.llm_type, config.model.tokenizer_path)
        tpl = prompt_template_for(config.model.llm_type)
        self.prefix_ids = self.tokenizer.encode(tpl.prefix, add_bos=True)
        self.suffix_ids = self.tokenizer.encode(tpl.suffix, add_bos=False)

        # models: the LLM from one generator, the encoder from the next seed
        param_dtype = _DTYPES[config.model.param_dtype]
        name = config.model.llm_preset or config.model.llm_type
        if is_mla_moe(name):
            raise not_ported("KD training", mla_moe_preset(name))
        self.llm_cfg = llama_preset(name)
        if config.model.llm_checkpoint:
            self.llm_params = ckpt.load_params(config.model.llm_checkpoint, self.device,
                                               param_dtype)["llm_params"]
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.llm_params = init_llama_params(gen, self.llm_cfg, dtype=param_dtype,
                                                device=self.device)
        if config.model.llm_weight_dtype == "int8":
            # weight-only int8 for the frozen LLM: no gradient touches it
            self.llm_params = quantize_llama_params(self.llm_params)
        # under a model group: the whole embedding table (the splice's and
        # the validation prompts' rows) and this rank's shard; the rest of
        # the whole tree goes
        self.embed_table = None
        if self.mesh.model > 1:
            self.embed_table = {k: self.llm_params[k] for k in
                                ("embed_tokens", "embed_tokens_scale") if k in self.llm_params}
            self.llm_params = shard_llama_params(self.llm_params, self.llm_cfg,
                                                 self.mesh.model_rank, self.mesh.model)
        self.enc_setup = encoder_setup_from_config(config)
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        enc_params = init_audio_encoder(gen, self.enc_setup, dtype=torch.float32,
                                        device=self.device)

        self.train_ds, self.val_ds = load_training_datasets(config, self.tokenizer)

        tcfg = config.train
        # ceil: the tail of each epoch is a (smaller) real batch
        self.steps_per_epoch = max(-(-len(self.train_ds) // tcfg.batch_size), 1)
        total_opt_steps = tcfg.epochs * self.steps_per_epoch // max(tcfg.grad_accum_interval, 1)
        self.total_opt_steps = max(total_opt_steps, 1)
        self.state, self.optimizer = make_train_state(config, enc_params, self.total_opt_steps,
                                                      data_group=self.mesh.data_group)
        del enc_params

        self._train_steps = {}
        # "positions" and "valid_positions" of the student's splices
        # (``make_train_step``'s counts), logged as valid_position_share
        self.counts: Counter = Counter()
        self._eval_steps = {}
        self._val_engine = None
        self.step = 0
        self.start_epoch = 0
        # batches consumed in the current epoch (saved in checkpoints)
        self._epoch_step = 0
        self._resume_epoch_step = 0
        if not checkpoint_path:
            checkpoint_path = ckpt.latest_checkpoint(self.checkpoint_dir)
        if self.world is not None:  # every rank resumes from rank 0's choice
            chosen = [checkpoint_path]
            dist.broadcast_object_list(chosen, src=0)
            checkpoint_path = chosen[0]
        if checkpoint_path:
            self.load_checkpoint(checkpoint_path)

    # ------------------------------------------------------------------

    def load_checkpoint(self, path: str):
        """Resume encoder params, optimizer state and step/epoch."""
        restored, step, epoch = ckpt.restore_train_checkpoint(path, self.state)
        self.state.enc_params = restored["enc_params"]
        # the file holds the whole state: this rank's ZeRO-1 slices of it
        self.state.opt_state = self.optimizer.slice_state(restored["opt_state"])
        self.state.step = step
        self.step = step
        self.start_epoch = epoch
        self._resume_epoch_step = int(restored["epoch_step"])
        print(f"Resumed from {path} at step {step}, epoch {epoch}"
              f" (+{self._resume_epoch_step} batches into it)")

    def total_len(self, audio_bucket: int) -> int:
        return spliced_length(self.config, self.enc_setup, len(self.prefix_ids),
                              len(self.suffix_ids), audio_bucket)

    def _mesh_args(self, total_len: int) -> dict:
        """The step's groups: the spliced T is sharded over the seq group,
        so ``total_len`` must divide by its size."""
        if self.group is not None and total_len % self.mesh.seq:
            raise ValueError(f"total_len={total_len} is not divisible by seq={self.mesh.seq}")
        return {"group": self.group, "tp_group": self.mesh.model_group,
                "embed_table": self.embed_table}

    def _get_train_step(self, audio_bucket: int):
        if audio_bucket not in self._train_steps:
            total_len = self.total_len(audio_bucket)
            self._train_steps[audio_bucket] = make_train_step(
                self.config, self.enc_setup, self.llm_cfg, self.optimizer, self.prefix_ids,
                self.suffix_ids, total_len, device=self.device, data_group=self.mesh.data_group,
                counts=self.counts, **self._mesh_args(total_len))
        return self._train_steps[audio_bucket]

    def _get_eval_step(self, audio_bucket: int):
        if audio_bucket not in self._eval_steps:
            total_len = self.total_len(audio_bucket)
            self._eval_steps[audio_bucket] = make_eval_step(
                self.config, self.enc_setup, self.llm_cfg, self.prefix_ids, self.suffix_ids,
                total_len, device=self.device, **self._mesh_args(total_len))
        return self._eval_steps[audio_bucket]

    def _save(self, epoch: int, block: bool) -> None:
        """Rank 0 saves the whole state (ZeRO-1's slices gathered by every
        rank first); in a multi-process run the save blocks and a barrier
        follows, so every rank finds the checkpoint afterwards."""
        whole = self.optimizer.whole_state(self.state.opt_state, self.state.enc_params)
        if self.mesh.is_main:
            ckpt.save_train_checkpoint(
                self.checkpoint_dir, self.step, epoch,
                TrainState(self.state.step, self.state.enc_params, whole),
                block=block or self.world is not None, epoch_step=self._epoch_step)
        if self.world is not None:
            dist.barrier()

    def _agree_bucket(self, batch: Batch) -> Batch:
        """This rank's rows zero-padded to the largest audio bucket of the
        global batch (every rank of a step must splice one length)."""
        N = max_over_ranks(batch.wav.shape[1], self.mesh.data_group)
        if N == batch.wav.shape[1]:
            return batch
        wav = np.zeros((batch.wav.shape[0], N), np.float32)
        wav[:, : batch.wav.shape[1]] = batch.wav
        return batch._replace(wav=wav)

    def _batches(self, dataset, batch_size: int, shuffle: bool, seed: int,
                 skip: int = 0, data_shard: bool = False) -> Iterator[Batch]:
        """Collated batches in a seeded order, the first ``skip`` dropped
        (resume); ``num_workers`` > 1 collates that many batches ahead on
        threads. The tail of the dataset is one smaller batch.
        ``data_shard``: this data rank's strided part of the order and of
        each batch (see the module docstring)."""
        idx = np.arange(len(dataset))
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        D = self.mesh.data
        if data_shard and D > 1:  # equal shards: every rank takes as many steps
            idx = idx[self.mesh.data_rank::D][: len(idx) // D]
            batch_size //= D
        bcfg = self.config.train.buckets
        n_ranges = max_pool_ranges(self.config, self.enc_setup)

        def make(i):
            return collate_batch(
                [dataset[int(j)] for j in idx[i: i + batch_size]],
                audio_buckets=bcfg.audio_samples,
                max_text_tokens=bcfg.max_text_tokens,
                max_response_tokens=bcfg.max_response_tokens,
                max_pool_ranges=n_ranges,
            )

        starts = list(range(0, len(idx), batch_size))[skip:]
        workers = max(self.config.train.num_workers, 1)
        if workers <= 1 or len(starts) <= 1:
            for i in starts:
                yield make(i)
            return

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as pool:
            pending = [pool.submit(make, i) for i in starts[: workers + 1]]
            next_submit = workers + 1
            while pending:
                fut = pending.pop(0)
                if next_submit < len(starts):
                    pending.append(pool.submit(make, starts[next_submit]))
                    next_submit += 1
                yield fut.result()

    # ------------------------------------------------------------------

    def train_step(self, batch: Batch):
        """One KD step on ``batch``; returns the metrics (device tensors)."""
        step_fn = self._get_train_step(batch.wav.shape[1])
        self.state, metrics = step_fn(self.state, self.llm_params, batch)
        self.step += 1
        self._epoch_step += 1
        return metrics

    def train(self):
        cfg = self.config
        tcfg = cfg.train
        log_int = cfg.log.log_interval
        val_int = cfg.log.validation_interval
        self._stop_requested = False

        def _on_sigterm(signum, frame):
            self._stop_requested = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not in the main thread
            prev_handler = None
        # the trace window: LSS_PROFILE_DIR=/dir [LSS_PROFILE_STEPS=N, 3]
        # traces steps 3..2+N (past the first steps' kernel builds and
        # allocator growth) into /dir, as obs.profile.trace writes it
        prof_dir = os.environ.get("LSS_PROFILE_DIR")
        prof_steps = int(os.environ.get("LSS_PROFILE_STEPS", "3"))
        window = contextlib.ExitStack()
        logged = Counter(self.counts)  # the counts at the last log
        try:
            # a resumed run finishes the configured epochs, no more
            for epoch in range(self.start_epoch, tcfg.epochs):
                print(f"Epoch {epoch}")
                t0 = time.time()
                skip = self._resume_epoch_step if epoch == self.start_epoch else 0
                self._epoch_step = skip
                for batch in self._batches(self.train_ds, tcfg.batch_size, True,
                                           cfg.seed_everything + epoch, skip=skip,
                                           data_shard=True):
                    metrics = self.train_step(self._agree_bucket(batch))
                    if prof_dir and self.step == 2:
                        window.enter_context(trace(prof_dir))
                    elif prof_dir and self.step == 2 + prof_steps:
                        window.close()
                        print(f"profile trace written to {prof_dir}")
                        prof_dir = None
                    if self.step % log_int == 0 and self.writer is not None:
                        host = {k: float(v) for k, v in metrics.items()}
                        host["step_time_s"] = (time.time() - t0) / log_int
                        t0 = time.time()
                        # the share of the student's positions that held
                        # prompt or response since the last log (the rest
                        # is padding the step computes all the same)
                        pos = self.counts["positions"] - logged["positions"]
                        if pos:
                            host["valid_position_share"] = (
                                self.counts["valid_positions"] - logged["valid_positions"]) / pos
                        logged = Counter(self.counts)
                        self.writer.log_training(host, self.step)
                        opt_step = self.step // max(tcfg.grad_accum_interval, 1)
                        self.writer.log_lr(lr_at(cfg, self.total_opt_steps, opt_step),
                                           self.step)
                    if val_int and self.step % val_int == 0:
                        self.validate(epoch)
                        t0 = time.time()  # step_time_s does not bill eval time
                    # every rank stops at the same step (a collective)
                    if any_rank(self._stop_requested, self.world):
                        print("SIGTERM received: checkpointing and stopping")
                        ckpt.finalize_saves()
                        self._save(epoch, block=True)
                        return
                    if tcfg.steps is not None and self.step >= tcfg.steps:
                        self.validate(epoch)
                        return
                self.validate(epoch)
        finally:
            window.close()  # a run that stops inside the window still writes it
            # async saves drain here, so callers can rely on the files
            ckpt.finalize_saves()
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    # ------------------------------------------------------------------

    def validate(self, epoch: int):
        """Eval NLL/perplexity, sample generations, checkpoint."""
        cfg = self.config
        # exact token-weighted aggregation across batches: ppl =
        # exp(sum nll / sum tokens)
        audio_sum = audio_tok = text_sum = text_tok = 0.0
        n_batches = 0
        val_bs = min(cfg.train.batch_size, 8)
        for batch in self._batches(self.val_ds, val_bs, False, 0):
            # this data rank's rows of the global batch, padded with rows
            # of zero tokens to a multiple of the data ranks
            batch = shard_batch(batch, self.mesh.data_rank, self.mesh.data)
            eval_fn = self._get_eval_step(batch.wav.shape[1])
            sums = all_reduce(torch.stack(eval_fn(self.state.enc_params, self.llm_params, batch)),
                              self.mesh.data_group)
            a_sum, a_tok, t_sum, t_tok = (float(x) for x in sums)
            audio_sum += a_sum
            audio_tok += a_tok
            text_sum += t_sum
            text_tok += t_tok
            n_batches += 1
            if self.writer is not None:
                self.writer.log_validation(a_sum / max(a_tok, 1.0), self.step)
        if n_batches and self.writer is not None:
            audio_ppl = float(np.exp(audio_sum / max(audio_tok, 1.0)))
            text_ppl = float(np.exp(text_sum / max(text_tok, 1.0)))
            self.writer.log_validation_perplexity(audio_ppl, text_ppl, self.step)
            print(f"[val] step {self.step}: audio_ppl={audio_ppl:.3f} text_ppl={text_ppl:.3f}")

        n_gen = cfg.log.num_generate_samples
        # rank 0's model group generates (the engine runs over it)
        generates = self.mesh.data_rank == 0 and self.mesh.seq_rank == 0
        if n_gen > 0 and len(self.val_ds) > 0 and generates:
            if self._val_engine is None:
                from ..infer.engine import LLMSpeechTextInference

                # one engine for every validate; its encoder params refresh.
                # Under a model group the engine takes this rank's shard and
                # the whole embedding table the prompts are built from.
                table = self.embed_table
                self._val_engine = LLMSpeechTextInference(
                    cfg, audio_encoder_params=self.state.enc_params,
                    llm_params=self.llm_params, llm_cfg=self.llm_cfg,
                    encoder_cfg=self.enc_setup.encoder_cfg, device=self.device,
                    mesh=self.mesh if self.mesh.model > 1 else None,
                    prompt_table=(table["embed_tokens"], table.get("embed_tokens_scale"))
                    if self.mesh.model > 1 else None)
            engine = self._val_engine
            engine.audio_encoder_params = self.state.enc_params
            use_ctc = self.enc_setup.downsample_method == "ctc_pool"
            prompts, audio_resps, text_resps, audios = [], [], [], []
            for i in range(min(n_gen, len(self.val_ds))):
                ex = self.val_ds[i]
                max_new = min(2 * max(len(ex["text_input_ids"]), 8), 128)
                ranges = np.asarray(ex["pool_ranges_4"], np.int32) if use_ctc else None
                audio_resps.append(engine.generate_audio_response(
                    ex["audio"], max_new_tokens=max_new, ctc_pool_ranges=ranges))
                text_resps.append(engine.generate_text_response(ex["text"],
                                                                max_new_tokens=max_new))
                prompts.append(ex["text"])
                audios.append(ex["audio"])
            if self.writer is not None:
                self.writer.log_audio_text_responses(
                    self.step, prompt_audios=audios, prompt_texts=prompts,
                    audio_responses=audio_resps, text_responses=text_resps,
                    sampling_rate=cfg.audio.sampling_rate,
                )

        self._save(epoch, block=not cfg.log.async_checkpoint)
