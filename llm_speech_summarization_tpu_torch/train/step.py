"""The knowledge-distillation train step and the eval step (port of
``train/step.py``).

  student:  waveform → audio encoder → [prefix|audio|suffix|response]
            splice → frozen LLM forward; gradients flow to the encoder
  teacher:  [prefix|transcript|suffix|response] splice → the same frozen
            LLM, a separate forward without gradients

Both sequences are left-padded to the same length, so the response windows
(the last W = R + 1 positions) line up and the losses share one mask:
  ntp — response-window CE, ld — soft CE against the teacher's logits,
  fd — MSE on the hidden states of the configured layers.
With a teacher, ntp and ld come from the final hidden states through the
vocab-chunked fused loss (no (B, W, V) logits slab).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs import Config
from ..data.batch import Batch
from ..device import resolve_device
from ..models.audio_encoder import AudioEncoderParams, audio_encoder_forward
from ..models.llama import LlamaConfig, llama_forward
from ..ops.losses import (
    feature_distillation_loss,
    fused_ntp_ld_losses,
    response_cross_entropy,
    response_nll_sum,
)
from ..ops.splice import splice_sequences
from .state import AdamW, TrainState, tree_leaves

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _embed_table(llm_params, compute_dtype):
    """(table, scale) for splicing: an int8 table passes through with its
    per-row scale (the splice dequantizes after its gather)."""
    emb = llm_params["embed_tokens"]
    if emb.dtype == torch.int8:
        return emb, llm_params["embed_tokens_scale"]
    return emb.to(compute_dtype), None


def _embed_rows(table, table_scale, ids, compute_dtype):
    ids = ids.long()
    rows = table[ids].to(compute_dtype)
    if table_scale is not None:
        rows = rows * table_scale[ids][..., None].to(compute_dtype)
    return rows


def _forward_losses(
    enc_params,
    llm_params,
    batch: Batch,
    *,
    enc_setup: AudioEncoderParams,
    llm_cfg: LlamaConfig,
    cfg: Config,
    prefix_ids: torch.Tensor,
    suffix_ids: torch.Tensor,
    total_len: int,
    remat: bool,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    tcfg = cfg.train
    compute_dtype = _DTYPES[cfg.model.compute_dtype]
    table, table_scale = _embed_table(llm_params, compute_dtype)

    audio_embeds, emb_lens = audio_encoder_forward(
        enc_params, enc_setup, batch.wav.to(compute_dtype), batch.wav_lens, remat=remat)
    student = splice_sequences(
        table, prefix_ids, suffix_ids, audio_embeds, emb_lens,
        batch.response_ids, batch.response_lens, total_len=total_len, table_scale=table_scale,
    )
    W = batch.response_ids.shape[1] + 1
    labels = student.labels[:, -W:]
    loss_mask = student.loss_mask[:, -W:]
    response_mask = student.response_mask[:, -W:]
    losses: Dict[str, torch.Tensor] = {}

    if tcfg.use_ld_loss or tcfg.use_fd_loss:
        out = llama_forward(
            llm_params, llm_cfg, inputs_embeds=student.embeds, attn_mask=student.attn_mask,
            return_hidden=tcfg.use_fd_loss, hidden_window=W, compute_logits=False,
            return_final_hidden=True, logit_window=W, remat=remat,
            remat_policy=tcfg.remat_policy,
        )
        with torch.no_grad():  # the teacher: a constant target, no graph
            text_embeds = _embed_rows(table, table_scale, batch.text_ids, compute_dtype)
            teacher = splice_sequences(
                table, prefix_ids, suffix_ids, text_embeds, batch.text_lens,
                batch.response_ids, batch.response_lens, total_len=total_len,
                table_scale=table_scale,
            )
            t_out = llama_forward(
                llm_params, llm_cfg, inputs_embeds=teacher.embeds, attn_mask=teacher.attn_mask,
                return_hidden=tcfg.use_fd_loss, hidden_window=W, compute_logits=False,
                return_final_hidden=True, logit_window=W,
            )
        if llm_cfg.tie_embeddings:
            head_vd, head_scale = llm_params["embed_tokens"], llm_params.get("embed_tokens_scale")
        else:
            head_vd, head_scale = llm_params["lm_head"].t(), llm_params.get("lm_head_scale")
        ntp, ld = fused_ntp_ld_losses(
            out.final_hidden, t_out.final_hidden, head_vd, labels, loss_mask, response_mask,
            head_scale=head_scale if head_vd.dtype == torch.int8 else None,
        )
    else:
        out = llama_forward(
            llm_params, llm_cfg, inputs_embeds=student.embeds, attn_mask=student.attn_mask,
            logit_window=W, remat=remat, remat_policy=tcfg.remat_policy,
        )
        ntp, ld = response_cross_entropy(out.logits, labels, loss_mask), None

    losses["ntp_loss"] = ntp
    total = tcfg.ntp_loss_weight * ntp
    if tcfg.use_ld_loss:
        losses["ld_loss"] = ld
        total = total + tcfg.ld_loss_weight * ld
    if tcfg.use_fd_loss:
        fd = feature_distillation_loss(out.hidden_states, t_out.hidden_states,
                                       tuple(tcfg.fd_loss_connector_layers), response_mask)
        losses["fd_loss"] = fd
        total = total + tcfg.fd_loss_weight * fd
    losses["total_loss"] = total
    return total, losses


def _device_ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=torch.int32).to(device)


def make_train_step(
    cfg: Config,
    enc_setup: AudioEncoderParams,
    llm_cfg: LlamaConfig,
    optimizer: AdamW,
    prefix_ids,
    suffix_ids,
    total_len: int,
    device=None,
):
    """The train step: (state, llm_params, batch) → (state, metrics).
    ``state`` is updated in place (parameters, optimizer state, step) and
    returned; metrics are the losses and ``grad_norm`` (the global norm of
    this step's gradients) as float32 0-d tensors on the device, read by
    the caller when it logs. Gradients reach only the encoder parameters;
    the LLM is frozen. ``device=None`` is the CUDA card and raises without
    one; the batch moves there."""
    dev = resolve_device(device)
    prefix_ids, suffix_ids = _device_ids(prefix_ids, dev), _device_ids(suffix_ids, dev)

    def step_fn(state: TrainState, llm_params, batch: Batch):
        batch = batch.to_device(dev)
        total, losses = _forward_losses(
            state.enc_params, llm_params, batch, enc_setup=enc_setup, llm_cfg=llm_cfg,
            cfg=cfg, prefix_ids=prefix_ids, suffix_ids=suffix_ids, total_len=total_len,
            remat=cfg.train.remat,
        )
        leaves = tree_leaves(state.enc_params)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        metrics = {k: v.detach().float() for k, v in losses.items()}
        metrics["grad_norm"] = torch.sqrt(sum(g.float().square().sum() for g in grads))
        optimizer.apply(state, grads)
        state.step += 1
        return state, metrics

    return step_fn


def make_eval_step(
    cfg: Config,
    enc_setup: AudioEncoderParams,
    llm_cfg: LlamaConfig,
    prefix_ids,
    suffix_ids,
    total_len: int,
    device=None,
):
    """Validation NLLs of the audio- and the text-prompted sequences, for an
    exact token-weighted perplexity across batches: returns
    ``(audio_sum_nll, audio_tokens, text_sum_nll, text_tokens)`` as 0-d
    tensors. Student and teacher run as one stacked (2B, L) forward.
    ``device=None`` is the CUDA card and raises without one."""
    dev = resolve_device(device)
    prefix_ids, suffix_ids = _device_ids(prefix_ids, dev), _device_ids(suffix_ids, dev)

    @torch.no_grad()
    def eval_fn(enc_params, llm_params, batch: Batch):
        batch = batch.to_device(dev)
        compute_dtype = _DTYPES[cfg.model.compute_dtype]
        table, table_scale = _embed_table(llm_params, compute_dtype)
        audio_embeds, emb_lens = audio_encoder_forward(
            enc_params, enc_setup, batch.wav.to(compute_dtype), batch.wav_lens)
        common = dict(total_len=total_len, table_scale=table_scale)
        student = splice_sequences(table, prefix_ids, suffix_ids, audio_embeds, emb_lens,
                                   batch.response_ids, batch.response_lens, **common)
        text_embeds = _embed_rows(table, table_scale, batch.text_ids, compute_dtype)
        teacher = splice_sequences(table, prefix_ids, suffix_ids, text_embeds, batch.text_lens,
                                   batch.response_ids, batch.response_lens, **common)
        W = batch.response_ids.shape[1] + 1
        out = llama_forward(
            llm_params, llm_cfg,
            inputs_embeds=torch.cat([student.embeds, teacher.embeds]),
            attn_mask=torch.cat([student.attn_mask, teacher.attn_mask]), logit_window=W,
        )
        B = batch.wav.shape[0]
        a_sum, a_tok = response_nll_sum(out.logits[:B], student.labels[:, -W:],
                                        student.loss_mask[:, -W:])
        t_sum, t_tok = response_nll_sum(out.logits[B:], teacher.labels[:, -W:],
                                        teacher.loss_mask[:, -W:])
        return a_sum, a_tok, t_sum, t_tok

    return eval_fn
