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

Sequence parallelism (``group``, a process group of the mesh's seq axis):
every rank of the group takes the same batch and builds the same splice;
the student's and the teacher's LLM forwards keep the rank's shard of the
sequence and run ring attention, and with ``train.encoder_sp`` the HuBERT
frames are sharded too. The response windows come back on every rank, so
the losses are equal on every rank. Each rank's encoder gradients cover
its shard; they are summed over the group before the global-norm clip, so
``grad_norm`` and the update are those of the full gradient, the same on
every rank.

Data parallelism (``data_group``): each data rank takes its rows of the
global batch. Every loss divides by its count over the global batch
(``ops/losses.py``), so a rank's loss is its rows' share and the global
loss is the sum over the group: the gradients are summed over the data
group (after the seq group) before the clip, and the metrics are the sums,
the JAX step's numbers on the global batch. The optimizer (``AdamW`` with
ZeRO-1) then updates every rank's copy of the encoder alike.

Tensor parallelism (``tp_group``): the LLM is this rank's shard
(``parallel/sharding.py``) and every rank of the group passes the same
rows. The block's collectives run inside ``llama_forward``; the fused loss
is vocab-parallel over the shard's head rows; the splice takes its token
rows from ``embed_table``, the whole embedding table (and its scale) that
the caller keeps from the tree it sharded. The encoder's gradients come
out the same on every rank of the group and are not summed over it.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import Config
from ..data.batch import Batch
from ..device import exact_float32, resolve_device
from ..models.audio_encoder import (
    AudioEncoderParams,
    audio_embed_buffer_len,
    audio_embed_lengths,
    audio_encoder_forward,
    encoder_frame_count,
)
from ..models.llama import LlamaConfig, llama_forward
from ..obs.profile import annotate
from ..ops.losses import (
    feature_distillation_loss,
    fused_ntp_ld_losses,
    response_cross_entropy,
    response_nll_sum,
)
from ..ops.splice import splice_sequences
from ..parallel.comm import all_reduce, all_reduce_grads, group_size
from .state import AdamW, TrainState, tree_leaves

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _embed_table(llm_params, compute_dtype):
    """(table, scale) for splicing: an int8 table passes through with its
    per-row scale (the splice dequantizes after its gather)."""
    emb = llm_params["embed_tokens"]
    if emb.dtype == torch.int8:
        return emb, llm_params["embed_tokens_scale"]
    return emb.to(compute_dtype), None


def _check_table(tp_group, embed_table) -> None:
    if group_size(tp_group) > 1 and embed_table is None:
        raise ValueError("a model group's shard splices from the whole embedding table: "
                         "pass embed_table")


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
    group=None,
    data_group=None,
    tp_group=None,
    embed_table=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    tcfg = cfg.train
    compute_dtype = _DTYPES[cfg.model.compute_dtype]
    table, table_scale = _embed_table(embed_table or llm_params, compute_dtype)

    with annotate("lss.train.encoder"):
        audio_embeds, emb_lens = audio_encoder_forward(
            enc_params, enc_setup, batch.wav.to(compute_dtype), batch.wav_lens,
            ctc_pool_ranges=batch.ctc_pool_ranges, remat=remat,
            sp_group=group if tcfg.encoder_sp else None)
    W = batch.response_ids.shape[1] + 1
    with_teacher = tcfg.use_ld_loss or tcfg.use_fd_loss
    with annotate("lss.train.student"):
        student = splice_sequences(
            table, prefix_ids, suffix_ids, audio_embeds, emb_lens,
            batch.response_ids, batch.response_lens, total_len=total_len,
            table_scale=table_scale,
        )
        if with_teacher:
            out = llama_forward(
                llm_params, llm_cfg, inputs_embeds=student.embeds, attn_mask=student.attn_mask,
                return_hidden=tcfg.use_fd_loss, hidden_window=W, compute_logits=False,
                return_final_hidden=True, logit_window=W, remat=remat,
                remat_policy=tcfg.remat_policy, ring_group=group, tp_group=tp_group,
            )
        else:
            out = llama_forward(
                llm_params, llm_cfg, inputs_embeds=student.embeds, attn_mask=student.attn_mask,
                logit_window=W, remat=remat, remat_policy=tcfg.remat_policy, ring_group=group,
                tp_group=tp_group,
            )
    labels = student.labels[:, -W:]
    loss_mask = student.loss_mask[:, -W:]
    response_mask = student.response_mask[:, -W:]
    losses: Dict[str, torch.Tensor] = {}

    if with_teacher:
        # the teacher: a constant target, no graph
        with torch.no_grad(), annotate("lss.train.teacher"):
            text_embeds = _embed_rows(table, table_scale, batch.text_ids, compute_dtype)
            teacher = splice_sequences(
                table, prefix_ids, suffix_ids, text_embeds, batch.text_lens,
                batch.response_ids, batch.response_lens, total_len=total_len,
                table_scale=table_scale,
            )
            t_out = llama_forward(
                llm_params, llm_cfg, inputs_embeds=teacher.embeds, attn_mask=teacher.attn_mask,
                return_hidden=tcfg.use_fd_loss, hidden_window=W, compute_logits=False,
                return_final_hidden=True, logit_window=W, ring_group=group, tp_group=tp_group,
            )

    with annotate("lss.train.loss"):
        if with_teacher:
            if llm_cfg.tie_embeddings:
                head_vd = llm_params["embed_tokens"]
                head_scale = llm_params.get("embed_tokens_scale")
            else:
                head_vd, head_scale = llm_params["lm_head"].t(), llm_params.get("lm_head_scale")
            ntp, ld = fused_ntp_ld_losses(
                out.final_hidden, t_out.final_hidden, head_vd, labels, loss_mask, response_mask,
                head_scale=head_scale if head_vd.dtype == torch.int8 else None,
                data_group=data_group, tp_group=tp_group,
            )
        else:
            ntp, ld = response_cross_entropy(out.logits, labels, loss_mask, data_group), None
        losses["ntp_loss"] = ntp
        total = tcfg.ntp_loss_weight * ntp
        if tcfg.use_ld_loss:
            losses["ld_loss"] = ld
            total = total + tcfg.ld_loss_weight * ld
        if tcfg.use_fd_loss:
            fd = feature_distillation_loss(out.hidden_states, t_out.hidden_states,
                                           tuple(tcfg.fd_loss_connector_layers), response_mask,
                                           data_group)
            losses["fd_loss"] = fd
            total = total + tcfg.fd_loss_weight * fd
        losses["total_loss"] = total
    return total, losses


def _device_ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=torch.int32).to(device)


def _valid_positions(batch: Batch, enc_setup: AudioEncoderParams, P: int, S: int) -> int:
    """The valid positions of the student's splice (its attention mask's
    sum) from the host batch's lengths: P + audio embeds + S + response a
    row, the audio embeds as ``audio_encoder_forward`` counts them."""
    N = batch.wav.shape[1]
    if enc_setup.downsample_method == "ctc_pool":
        r = np.asarray(batch.ctc_pool_ranges)
        frames = encoder_frame_count(enc_setup, N)
        mid = ((r[..., 1] > r[..., 0]) & (r[..., 0] < frames)).sum(axis=1)
        M = r.shape[1]
    else:
        mid = audio_embed_lengths(enc_setup, torch.as_tensor(np.asarray(batch.wav_lens))).numpy()
        M = audio_embed_buffer_len(enc_setup, N)
    return int(len(mid) * (P + S) + np.minimum(mid, M).sum()
               + np.asarray(batch.response_lens).sum())


def make_train_step(
    cfg: Config,
    enc_setup: AudioEncoderParams,
    llm_cfg: LlamaConfig,
    optimizer: AdamW,
    prefix_ids,
    suffix_ids,
    total_len: int,
    device=None,
    group=None,
    data_group=None,
    tp_group=None,
    embed_table=None,
    counts: Optional[Counter] = None,
):
    """The train step: (state, llm_params, batch) → (state, metrics).
    ``state`` is updated in place (parameters, optimizer state, step) and
    returned; metrics are the losses and ``grad_norm`` (the global norm of
    this step's gradients) as float32 0-d tensors on the device, read by
    the caller when it logs. Gradients reach only the encoder parameters;
    the LLM is frozen. ``device=None`` is the CUDA card and raises without
    one; the batch moves there. ``group``: the seq group of a
    sequence-parallel run (see the module docstring); ``total_len`` must
    divide by its size. ``data_group``: the data group, ``batch`` being
    this rank's rows of the global batch; ``tp_group``: the model group,
    ``llm_params`` being this rank's shard (the module docstring), and
    ``embed_table`` the whole table the splice reads (required with a
    model group of more than one rank); the metrics are the global batch's
    on every rank. ``counts``, when given, gains "positions", the student's
    B x T spliced positions, and "valid_positions", those its attention
    mask holds, counted from the host batch's lengths. Spans:
    ``lss.train.{to_device, encoder, student, teacher, loss, backward,
    optimizer}``, and ``lss.train.loss_backward`` in the fused loss's
    backward. On the card autograd runs the backward on a thread of its
    own, so ``lss.train.backward`` on the caller's thread launches nothing
    there: it labels the caller's wait, and only ``lss.train.loss_backward``
    opens on autograd's thread."""
    _check_table(tp_group, embed_table)
    dev = resolve_device(device)
    prefix_ids, suffix_ids = _device_ids(prefix_ids, dev), _device_ids(suffix_ids, dev)
    # the compute dtype on the device: at float32 on the card the backward,
    # remat's recompute included, runs without TF32, as the forward does
    compute = torch.empty(0, dtype=_DTYPES[cfg.model.compute_dtype], device=dev)

    def step_fn(state: TrainState, llm_params, batch: Batch):
        if counts is not None:
            counts["positions"] += batch.wav.shape[0] * total_len
            counts["valid_positions"] += _valid_positions(batch, enc_setup, len(prefix_ids),
                                                          len(suffix_ids))
        with annotate("lss.train.to_device"):
            batch = batch.to_device(dev)
        total, losses = _forward_losses(
            state.enc_params, llm_params, batch, enc_setup=enc_setup, llm_cfg=llm_cfg,
            cfg=cfg, prefix_ids=prefix_ids, suffix_ids=suffix_ids, total_len=total_len,
            remat=cfg.train.remat, group=group, data_group=data_group,
            tp_group=tp_group, embed_table=embed_table,
        )
        leaves = tree_leaves(state.enc_params)
        with exact_float32(compute), annotate("lss.train.backward"):
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        # before the clip: the full gradient of the global batch
        grads = all_reduce_grads(all_reduce_grads(grads, group), data_group)
        names = list(losses)
        sums = all_reduce(torch.stack([losses[k].detach().float() for k in names]), data_group)
        metrics = dict(zip(names, sums.unbind(0)))
        metrics["grad_norm"] = torch.sqrt(sum(g.float().square().sum() for g in grads))
        with annotate("lss.train.optimizer"):
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
    group=None,
    tp_group=None,
    embed_table=None,
):
    """Validation NLLs of the audio- and the text-prompted sequences, for an
    exact token-weighted perplexity across batches: returns
    ``(audio_sum_nll, audio_tokens, text_sum_nll, text_tokens)`` as 0-d
    tensors. Student and teacher run as one stacked (2B, L) forward.
    ``device=None`` is the CUDA card and raises without one. ``group``: the
    sequence-parallel forward of the train step, the same sums on every
    rank; ``tp_group`` and ``embed_table``: a sharded LLM's model group and
    whole table, as in the train step. The sums cover ``batch``; over a
    data group the caller adds the ranks' sums."""
    _check_table(tp_group, embed_table)
    dev = resolve_device(device)
    prefix_ids, suffix_ids = _device_ids(prefix_ids, dev), _device_ids(suffix_ids, dev)

    @torch.no_grad()
    def eval_fn(enc_params, llm_params, batch: Batch):
        batch = batch.to_device(dev)
        compute_dtype = _DTYPES[cfg.model.compute_dtype]
        table, table_scale = _embed_table(embed_table or llm_params, compute_dtype)
        audio_embeds, emb_lens = audio_encoder_forward(
            enc_params, enc_setup, batch.wav.to(compute_dtype), batch.wav_lens,
            ctc_pool_ranges=batch.ctc_pool_ranges,
            sp_group=group if cfg.train.encoder_sp else None)
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
            ring_group=group, tp_group=tp_group,
        )
        B = batch.wav.shape[0]
        a_sum, a_tok = response_nll_sum(out.logits[:B], student.labels[:, -W:],
                                        student.loss_mask[:, -W:])
        t_sum, t_tok = response_nll_sum(out.logits[B:], teacher.labels[:, -W:],
                                        teacher.loss_mask[:, -W:])
        return a_sum, a_tok, t_sum, t_tok

    return eval_fn
