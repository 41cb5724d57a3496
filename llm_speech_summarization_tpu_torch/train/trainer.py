"""Trainer: the KD training loop on one card (port of ``train/trainer.py``).

Init seeds every host RNG and a ``torch.Generator`` per model, builds the
frozen LLM (int8 weight-only when ``llm_weight_dtype`` is int8, in the
unfused training layout) and the trainable float32 encoder, the datasets,
the optimizer and the state, and resumes from the latest checkpoint of the
run (or a given one). ``train()`` runs epochs of collated, bucketed batches
with interval logging and validation, a step cap (``train.steps``), a
checkpoint on SIGTERM, and exact resume (``epoch_step``). ``validate()``
computes the token-weighted audio and text perplexities, samples
generations through ``LLMSpeechTextInference`` and checkpoints.

One card, no mesh: a config that asks for data/model/sequence parallelism,
ring attention or encoder sequence parallelism raises (ROADMAP queue A,
item 11), and ``ctc_pool`` raises in the encoder setup (item 4).
"""

from __future__ import annotations

import os
import random
import signal
import time
from typing import Iterator, Optional

import numpy as np
import torch

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
from ..obs.writer import MetricsWriter
from ..utils.prompts import prompt_template_for
from ..utils.tokenizer import load_tokenizer
from . import checkpoint as ckpt
from .state import lr_at, make_train_state
from .step import _DTYPES, make_eval_step, make_train_step


def _check_single_card(cfg: Config) -> None:
    tcfg = cfg.train
    asks = {
        "mesh.data > 1": tcfg.mesh.data > 1, "mesh.model > 1": tcfg.mesh.model > 1,
        "mesh.seq > 1": tcfg.mesh.seq > 1, "use_ring_attention": tcfg.use_ring_attention,
        "encoder_sp": tcfg.encoder_sp,
    }
    wanted = [name for name, on in asks.items() if on]
    if wanted:
        raise NotImplementedError(
            f"training with {', '.join(wanted)} is not ported to PyTorch yet (ROADMAP queue A, "
            f"item 11: parallelism; B7: ring attention); the port trains on one card")


def spliced_length(config: Config, enc_setup, n_prefix: int, n_suffix: int,
                   audio_bucket: int) -> int:
    """The one length of the student and teacher sequences for an audio
    bucket: prefix + max(audio embeds, text cap) + suffix + response cap,
    rounded up to 128."""
    M = audio_embed_buffer_len(enc_setup, audio_bucket)
    R = config.train.buckets.max_response_tokens
    T = config.train.buckets.max_text_tokens
    return ((n_prefix + max(M, T) + n_suffix + R + 127) // 128) * 128


class Trainer:
    def __init__(self, config: Config, run_name: str = "run",
                 checkpoint_path: Optional[str] = None, device=None):
        """``device=None`` is the CUDA card and raises without one; the CPU
        runs only with ``device="cpu"``."""
        _check_single_card(config)
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
        self.writer = MetricsWriter(self.log_dir, jsonl=config.log.jsonl_metrics)

        self.tokenizer = load_tokenizer(config.model.llm_type, config.model.tokenizer_path)
        tpl = prompt_template_for(config.model.llm_type)
        self.prefix_ids = self.tokenizer.encode(tpl.prefix, add_bos=True)
        self.suffix_ids = self.tokenizer.encode(tpl.suffix, add_bos=False)

        # models: the LLM from one generator, the encoder from the next seed
        param_dtype = _DTYPES[config.model.param_dtype]
        self.llm_cfg = llama_preset(config.model.llm_preset or config.model.llm_type)
        if config.model.llm_checkpoint or config.model.encoder_checkpoint:
            raise NotImplementedError(
                "loading converted weights is not ported to PyTorch yet (ROADMAP queue A, "
                "item 12)")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.llm_params = init_llama_params(gen, self.llm_cfg, dtype=param_dtype,
                                            device=self.device)
        if config.model.llm_weight_dtype == "int8":
            # weight-only int8 for the frozen LLM: no gradient touches it
            self.llm_params = quantize_llama_params(self.llm_params)
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
        self.state, self.optimizer = make_train_state(config, enc_params, self.total_opt_steps)
        del enc_params

        self._train_steps = {}
        self._eval_steps = {}
        self._val_engine = None
        self.step = 0
        self.start_epoch = 0
        # batches consumed in the current epoch (saved in checkpoints)
        self._epoch_step = 0
        self._resume_epoch_step = 0
        if checkpoint_path:
            self.load_checkpoint(checkpoint_path)
        else:
            latest = ckpt.latest_checkpoint(self.checkpoint_dir)
            if latest:
                self.load_checkpoint(latest)

    # ------------------------------------------------------------------

    def load_checkpoint(self, path: str):
        """Resume encoder params, optimizer state and step/epoch."""
        restored, step, epoch = ckpt.restore_train_checkpoint(path, self.state)
        self.state.enc_params = restored["enc_params"]
        self.state.opt_state = restored["opt_state"]
        self.state.step = step
        self.step = step
        self.start_epoch = epoch
        self._resume_epoch_step = int(restored["epoch_step"])
        print(f"Resumed from {path} at step {step}, epoch {epoch}"
              f" (+{self._resume_epoch_step} batches into it)")

    def total_len(self, audio_bucket: int) -> int:
        return spliced_length(self.config, self.enc_setup, len(self.prefix_ids),
                              len(self.suffix_ids), audio_bucket)

    def _get_train_step(self, audio_bucket: int):
        if audio_bucket not in self._train_steps:
            self._train_steps[audio_bucket] = make_train_step(
                self.config, self.enc_setup, self.llm_cfg, self.optimizer, self.prefix_ids,
                self.suffix_ids, self.total_len(audio_bucket), device=self.device)
        return self._train_steps[audio_bucket]

    def _get_eval_step(self, audio_bucket: int):
        if audio_bucket not in self._eval_steps:
            self._eval_steps[audio_bucket] = make_eval_step(
                self.config, self.enc_setup, self.llm_cfg, self.prefix_ids, self.suffix_ids,
                self.total_len(audio_bucket), device=self.device)
        return self._eval_steps[audio_bucket]

    def _batches(self, dataset, batch_size: int, shuffle: bool, seed: int,
                 skip: int = 0) -> Iterator[Batch]:
        """Collated batches in a seeded order, the first ``skip`` dropped
        (resume); ``num_workers`` > 1 collates that many batches ahead on
        threads. The tail of the dataset is one smaller batch."""
        idx = np.arange(len(dataset))
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        bcfg = self.config.train.buckets

        def make(i):
            return collate_batch(
                [dataset[int(j)] for j in idx[i: i + batch_size]],
                audio_buckets=bcfg.audio_samples,
                max_text_tokens=bcfg.max_text_tokens,
                max_response_tokens=bcfg.max_response_tokens,
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
        try:
            # a resumed run finishes the configured epochs, no more
            for epoch in range(self.start_epoch, tcfg.epochs):
                print(f"Epoch {epoch}")
                t0 = time.time()
                skip = self._resume_epoch_step if epoch == self.start_epoch else 0
                self._epoch_step = skip
                for batch in self._batches(self.train_ds, tcfg.batch_size, True,
                                           cfg.seed_everything + epoch, skip=skip):
                    metrics = self.train_step(batch)
                    if self.step % log_int == 0:
                        host = {k: float(v) for k, v in metrics.items()}
                        host["step_time_s"] = (time.time() - t0) / log_int
                        t0 = time.time()
                        self.writer.log_training(host, self.step)
                        opt_step = self.step // max(tcfg.grad_accum_interval, 1)
                        self.writer.log_lr(lr_at(cfg, self.total_opt_steps, opt_step),
                                           self.step)
                    if val_int and self.step % val_int == 0:
                        self.validate(epoch)
                        t0 = time.time()  # step_time_s does not bill eval time
                    if self._stop_requested:
                        print("SIGTERM received: checkpointing and stopping")
                        ckpt.finalize_saves()
                        ckpt.save_train_checkpoint(self.checkpoint_dir, self.step, epoch,
                                                   self.state, epoch_step=self._epoch_step)
                        return
                    if tcfg.steps is not None and self.step >= tcfg.steps:
                        self.validate(epoch)
                        return
                self.validate(epoch)
        finally:
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
            eval_fn = self._get_eval_step(batch.wav.shape[1])
            a_sum, a_tok, t_sum, t_tok = (float(x) for x in eval_fn(
                self.state.enc_params, self.llm_params, batch))
            audio_sum += a_sum
            audio_tok += a_tok
            text_sum += t_sum
            text_tok += t_tok
            n_batches += 1
            self.writer.log_validation(a_sum / max(a_tok, 1.0), self.step)
        if n_batches:
            audio_ppl = float(np.exp(audio_sum / max(audio_tok, 1.0)))
            text_ppl = float(np.exp(text_sum / max(text_tok, 1.0)))
            self.writer.log_validation_perplexity(audio_ppl, text_ppl, self.step)
            print(f"[val] step {self.step}: audio_ppl={audio_ppl:.3f} text_ppl={text_ppl:.3f}")

        n_gen = cfg.log.num_generate_samples
        if n_gen > 0 and len(self.val_ds) > 0:
            if self._val_engine is None:
                from ..infer.engine import LLMSpeechTextInference

                # one engine for every validate; its encoder params refresh
                self._val_engine = LLMSpeechTextInference(
                    cfg, audio_encoder_params=self.state.enc_params,
                    llm_params=self.llm_params, llm_cfg=self.llm_cfg,
                    encoder_cfg=self.enc_setup.encoder_cfg, device=self.device)
            engine = self._val_engine
            engine.audio_encoder_params = self.state.enc_params
            prompts, audio_resps, text_resps, audios = [], [], [], []
            for i in range(min(n_gen, len(self.val_ds))):
                ex = self.val_ds[i]
                max_new = min(2 * max(len(ex["text_input_ids"]), 8), 128)
                audio_resps.append(engine.generate_audio_response(ex["audio"],
                                                                  max_new_tokens=max_new))
                text_resps.append(engine.generate_text_response(ex["text"],
                                                                max_new_tokens=max_new))
                prompts.append(ex["text"])
                audios.append(ex["audio"])
            self.writer.log_audio_text_responses(
                self.step, prompt_audios=audios, prompt_texts=prompts,
                audio_responses=audio_resps, text_responses=text_resps,
                sampling_rate=cfg.audio.sampling_rate,
            )

        ckpt.save_train_checkpoint(self.checkpoint_dir, self.step, epoch, self.state,
                                   block=not cfg.log.async_checkpoint,
                                   epoch_step=self._epoch_step)
