"""Training losses (port of ``ops/losses.py``): response-window CE, logit
distillation, feature distillation, and the vocab-chunked fused NTP + LD
loss. All reductions are float32. The JAX package has no Pallas kernel
here, and neither does the port: these are plain PyTorch.

  * response_cross_entropy: per-sample mean CE over the response window,
    then the mean over samples with a non-empty window;
  * response_nll_sum: masked (sum NLL, token count) for validation
    perplexity;
  * soft_cross_entropy: -sum softmax(teacher) * log_softmax(student), masked
    mean;
  * fused_ntp_ld_losses: NTP and LD from final hidden states without the
    (N, V) logits slab: vocab chunks with an online log-sum-exp, each
    chunk's logits recomputed in the backward;
  * feature_distillation_loss: sum over layers of the masked MSE.

Data parallelism (``data_group``): each rank holds its rows of the global
batch, and every loss divides by a count over the whole batch (samples
with a response window, response positions). The counts are summed over
the data group first, so each rank's loss is its rows' share of the global
loss: the sum over the group is the JAX loss of the global batch, and so
is the sum of the ranks' gradients.

Tensor parallelism (``tp_group`` of ``fused_ntp_ld_losses``): the head
holds the rank's vocab rows. Each rank runs the online log-sum-exp over
its own rows, and the per-row statistics (maxima, rescaled sums, the
teacher dot, the label logit: a few floats a position, never the (N, V)
logits) are combined over the group; the backward gives the rank's share
of the hidden states' gradient, which ``tp_copy`` sums.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..obs.profile import annotate
from ..parallel.comm import all_reduce, group_rank, group_size, tp_copy

NEG = -1e30


def _global_count(x: torch.Tensor, data_group) -> torch.Tensor:
    """``x`` (a count of this rank's rows) summed over the data group."""
    return all_reduce(x, data_group)


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    m = torch.amax(x, dim=-1, keepdim=True).detach()
    shifted = x - m
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=-1, keepdim=True))


def _label_nll(logits, labels):
    logp = _log_softmax(logits)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def response_cross_entropy(logits, labels, loss_mask, data_group=None) -> torch.Tensor:
    """logits (B, L, V); labels (B, L) int; loss_mask (B, L) bool."""
    nll = _label_nll(logits, labels)
    mask = loss_mask.float()
    count = mask.sum(-1)
    per_sample = (nll * mask).sum(-1) / torch.clamp(count, min=1.0)
    has_any = (count > 0).float()
    n = _global_count(has_any.sum(), data_group)
    return (per_sample * has_any).sum() / torch.clamp(n, min=1.0)


def response_nll_sum(logits, labels, loss_mask):
    """(sum of the masked NLL, number of masked tokens), both float32."""
    nll = _label_nll(logits, labels)
    mask = loss_mask.float()
    return (nll * mask).sum(), mask.sum()


def soft_cross_entropy(student_logits, teacher_logits, mask, data_group=None) -> torch.Tensor:
    """Masked mean over positions of -sum_v p_teacher * log p_student; the
    teacher distribution is a constant target."""
    s_logp = _log_softmax(student_logits)
    t_prob = torch.softmax(teacher_logits.float(), dim=-1).detach()
    ce = -(t_prob * s_logp).sum(-1)
    m = mask.float()
    return (ce * m).sum() / torch.clamp(_global_count(m.sum(), data_group), min=1.0)


def _chunk_logits(h, head, scale, c0, c1):
    """float32 logits (N, c1 - c0) of bf16/float32 h against head rows
    [c0, c1): the head chunk is rounded to h's dtype (int8 is exact), the
    product summed in float32, an int8 head's per-row scale applied after."""
    w = head[c0:c1]
    w = w if w.dtype == torch.int8 else w.to(h.dtype)
    logits = h.float() @ w.float().t()
    if scale is not None:
        logits = logits * scale[c0:c1].float()
    return logits


def _row_weights(loss_mask, response_mask, data_group):
    """d ntp / d nll and d ld / d ld_row per flattened (B * W) row."""
    lm = loss_mask.float()
    count = lm.sum(-1, keepdim=True)
    has_any = (count > 0).float()
    rm = response_mask.float()
    n_any, n_resp = _global_count(torch.stack([has_any.sum(), rm.sum()]), data_group)
    w_ntp = lm * has_any / torch.clamp(count, min=1.0) / torch.clamp(n_any, min=1.0)
    w_ld = rm / torch.clamp(n_resp, min=1.0)
    return w_ntp.reshape(-1), w_ld.reshape(-1)


class _FusedNtpLd(torch.autograd.Function):
    """Forward: one pass over vocab chunks keeping, per row, the student's
    and teacher's running (max, sum of exp), sum_v exp(t_v - m_t) * s_v and
    the label logit (the JAX scan's carry). Backward: each chunk's student
    and teacher logits are recomputed, and
      d/ds_v = a * (softmax_s - onehot(label)) + b * (softmax_s - p_t),
    a and b being the rows' NTP and LD weights times the incoming
    gradients, goes back through the head chunk. The teacher and the head
    get no gradient. Under a model group the head holds the rank's vocab
    rows [lo, lo + V): the statistics are combined over the group after
    the pass, and the backward returns the rank's share of d(sh)."""

    @staticmethod
    def forward(ctx, sh, th, head, scale, labels, loss_mask, response_mask, vocab_chunk,
                data_group, tp_group):
        N = sh.shape[0]
        V = head.shape[0]
        dev = sh.device
        labels = labels.long() - group_rank(tp_group) * V  # rows of this rank's head
        m_s = torch.full((N,), NEG, device=dev)
        l_s = torch.zeros((N,), device=dev)
        m_t = torch.full((N,), NEG, device=dev)
        l_t = torch.zeros((N,), device=dev)
        t_dot = torch.zeros((N,), device=dev)
        label_logit = torch.full((N,), NEG, device=dev)
        for c0 in range(0, V, vocab_chunk):
            c1 = min(c0 + vocab_chunk, V)
            ls = _chunk_logits(sh, head, scale, c0, c1)
            lt = _chunk_logits(th, head, scale, c0, c1)
            m_s_new = torch.maximum(m_s, ls.amax(-1))
            l_s = l_s * torch.exp(m_s - m_s_new) + torch.exp(ls - m_s_new[:, None]).sum(-1)
            m_s = m_s_new
            m_t_new = torch.maximum(m_t, lt.amax(-1))
            alpha = torch.exp(m_t - m_t_new)
            e_t = torch.exp(lt - m_t_new[:, None])
            l_t = l_t * alpha + e_t.sum(-1)
            t_dot = t_dot * alpha + (e_t * ls).sum(-1)
            m_t = m_t_new
            rel = labels - c0
            in_chunk = (rel >= 0) & (rel < c1 - c0)
            gathered = torch.gather(ls, 1, rel.clamp(0, c1 - c0 - 1)[:, None])[:, 0]
            label_logit = torch.where(in_chunk, gathered, label_logit)
        if group_size(tp_group) > 1:  # every rank's vocab rows
            m_s_g, m_t_g, label_logit = all_reduce(torch.stack([m_s, m_t, label_logit]),
                                                   tp_group, "max")
            a_s, a_t = torch.exp(m_s - m_s_g), torch.exp(m_t - m_t_g)
            l_s, l_t, t_dot = all_reduce(torch.stack([l_s * a_s, l_t * a_t, t_dot * a_t]),
                                         tp_group)
            m_s, m_t = m_s_g, m_t_g
        lse_s = m_s + torch.log(torch.clamp(l_s, min=1e-30))
        w_ntp, w_ld = _row_weights(loss_mask, response_mask, data_group)
        ntp = ((lse_s - label_logit) * w_ntp).sum()
        ld = ((lse_s - t_dot / torch.clamp(l_t, min=1e-30)) * w_ld).sum()
        ctx.save_for_backward(sh, th, head, scale, labels, lse_s, m_t, l_t, w_ntp, w_ld)
        ctx.vocab_chunk = vocab_chunk
        return ntp, ld

    @staticmethod
    def backward(ctx, g_ntp, g_ld):
        with annotate("lss.train.loss_backward"):  # on autograd's thread on the card
            sh, th, head, scale, labels, lse_s, m_t, l_t, w_ntp, w_ld = ctx.saved_tensors
            a = (g_ntp * w_ntp)[:, None]
            b = (g_ld * w_ld)[:, None]
            inv_l_t = 1.0 / torch.clamp(l_t, min=1e-30)
            dh = torch.zeros(sh.shape, dtype=torch.float32, device=sh.device)
            V = head.shape[0]
            for c0 in range(0, V, ctx.vocab_chunk):
                c1 = min(c0 + ctx.vocab_chunk, V)
                ls = _chunk_logits(sh, head, scale, c0, c1)
                p_s = torch.exp(ls - lse_s[:, None])
                lt = _chunk_logits(th, head, scale, c0, c1)
                p_t = torch.exp(lt - m_t[:, None]) * inv_l_t[:, None]
                dls = (a + b) * p_s - b * p_t
                rel = labels - c0
                in_chunk = (rel >= 0) & (rel < c1 - c0)
                dls.scatter_add_(1, rel.clamp(0, c1 - c0 - 1)[:, None], -a * in_chunk[:, None])
                if scale is not None:
                    dls = dls * scale[c0:c1].float()
                w = head[c0:c1]
                w = w if w.dtype == torch.int8 else w.to(sh.dtype)
                dh += dls @ w.float()
            return dh.to(sh.dtype), None, None, None, None, None, None, None, None, None


def fused_ntp_ld_losses(
    student_hidden: torch.Tensor,
    teacher_hidden: torch.Tensor,
    head_vd: torch.Tensor,
    labels: torch.Tensor,
    loss_mask: torch.Tensor,
    response_mask: torch.Tensor,
    vocab_chunk: int = 8192,
    head_scale: Optional[torch.Tensor] = None,
    data_group=None,
    tp_group=None,
):
    """(ntp_loss, ld_loss) equal to response_cross_entropy and
    soft_cross_entropy on the full logits (up to summation order), from
    final hidden states (B, W, D) and the head in vocab-major (V, D) layout
    (the embedding table for tied weights), optionally int8 with its
    per-row ``head_scale`` (V,). At most one (B * W, vocab_chunk) float32
    chunk of logits exists at a time, in the forward and in the backward.
    The teacher is a constant target; the head gets no gradient.
    ``tp_group``: ``head_vd`` (and ``head_scale``) are the rank's
    contiguous vocab rows, every rank passing the same hidden states and
    labels (see the module docstring)."""
    B, W, D = student_hidden.shape
    return _FusedNtpLd.apply(
        tp_copy(student_hidden.reshape(B * W, D), tp_group),
        teacher_hidden.detach().reshape(B * W, D),
        head_vd.detach(), None if head_scale is None else head_scale.detach(),
        labels.reshape(B * W), loss_mask, response_mask, vocab_chunk, data_group, tp_group,
    )


def feature_distillation_loss(
    student_hidden: Sequence[torch.Tensor],
    teacher_hidden: Sequence[torch.Tensor],
    layers: Sequence[int],
    mask: torch.Tensor,
    data_group=None,
) -> torch.Tensor:
    """Sum over the selected layers of the masked-mean squared error; index
    0 is the embedding output, i the output of block i (HF layout). mask:
    (B, W) response window."""
    m = mask.float()[..., None]
    denom = torch.clamp(_global_count(m.sum(), data_group), min=1.0)
    total = torch.zeros((), dtype=torch.float32, device=mask.device)
    for i in layers:
        sh = student_hidden[i].float()
        th = teacher_hidden[i].detach().float()
        total = total + ((sh - th).square() * m).sum() / (denom * sh.shape[-1])
    return total
