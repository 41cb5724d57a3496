"""Plain PyTorch reference of one knowledge-distillation step of the audio
encoder (the paper's training): the student reads the clip's audio
embeddings, the teacher the transcript's tokens, both in the same chat
template followed by the same response, through the frozen decoder; the
loss is

    ntp_weight * NTP + ld_weight * LD + fd_weight * FD

  * NTP: per utterance the mean next-token NLL of the response (each
    response token predicted from the one before it), then the mean over
    the utterances;
  * LD: the mean over all response positions of the cross-entropy of the
    student's distribution against the teacher's;
  * FD: for each connector layer (0 the embeddings, i the output of block
    i) the squared error of the hidden states at the response positions,
    summed, over (response positions x hidden size);

then AdamW (bias-corrected moments, eps outside the root, no decay) on the
encoder and projector, at the linearly decaying learning rate. Utterances
are independent until the loss, so each is worked out alone and its share
of the loss (over the batch's counts) is back-propagated at once: the sum
is the batch's loss and gradient, and memory holds one utterance.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .model import F32, Precision, audio_embeds, llama, prompt, token_embeds


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: tensor} of a nested dict/list tree, in a fixed order."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(leaves(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def rebuild(tree, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """``tree``'s structure with the leaves of ``flat``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, flat, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, flat, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return flat[prefix]


def utterance_loss(llm, enc, config: dict, ex: dict, counts: Tuple[int, int],
                   prec: Precision = F32, parts: Optional[dict] = None) -> torch.Tensor:
    """One utterance's share of the batch loss; ``counts`` = (utterances
    with a predicted token, response positions) of the whole batch.
    ``parts``, when given, gains "fd": the utterance's own FD loss (its
    squared error over its response positions x hidden size)."""
    tr = config["train"]
    n_any, n_resp = counts
    resp = ex["response_ids"]
    R = len(resp)
    r_emb = token_embeds(llm, resp)
    layers = list(tr["fd_loss_connector_layers"])
    audio = audio_embeds(enc, config, ex["wav"], ex["batch_samples"], prec)
    s_in = torch.cat([prompt(llm, config, audio), r_emb])
    with torch.no_grad():
        t_in = torch.cat([prompt(llm, config, None, ex["text_ids"]), r_emb])
        t_logits, t_hid = llama(llm, config["llm"], t_in, prec, hidden_at=layers,
                                logits_from=t_in.shape[0] - R)
    s_logits, s_hid = llama(llm, config["llm"], s_in, prec, hidden_at=layers,
                            logits_from=s_in.shape[0] - R)
    logp = torch.log_softmax(s_logits, dim=-1)
    labels = torch.as_tensor(resp[1:], dtype=torch.long, device=logp.device)
    total = torch.zeros((), device=logp.device)
    if R >= 2:
        ntp = -logp[:-1].gather(1, labels[:, None]).mean()
        total = total + tr["ntp_loss_weight"] * ntp / n_any
    if tr["use_ld_loss"]:
        ld = -(torch.softmax(t_logits, -1) * logp).sum()
        total = total + tr["ld_loss_weight"] * ld / n_resp
    if tr["use_fd_loss"]:
        D = s_in.shape[1]
        fd = sum((s_hid[i][-R:] - t_hid[i][-R:]).square().sum() for i in layers)
        total = total + tr["fd_loss_weight"] * fd / (n_resp * D)
        if parts is not None:
            parts["fd"] = float(fd.detach()) / (R * D)
    return total


def batch_counts(batch: Sequence[dict]) -> Tuple[int, int]:
    return sum(len(ex["response_ids"]) >= 2 for ex in batch), sum(len(ex["response_ids"])
                                                                   for ex in batch)


def kd_steps(llm, enc0, config: dict, batches: Sequence[Sequence[dict]],
             lr_at, prec: Precision = F32) -> dict:
    """Follow len(batches) steps from the encoder ``enc0``. Returns
    {"loss": [per step], "rows1": [each utterance's FD loss in step 1],
    "grad1": {leaf: first gradient}, "params": {leaf: parameters after the
    last step}, "params0": {leaf: the start}}."""
    opt = config["train"]["optimizer"]
    b1, b2, eps = opt["beta1"], opt["beta2"], 1e-8
    p0 = {k: v.detach().float().clone() for k, v in leaves(enc0).items()}
    params = {k: v.clone().requires_grad_() for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p0.items()}
    out: dict = {"loss": [], "rows1": [], "params0": p0}
    for t, batch in enumerate(batches, start=1):
        enc = rebuild(enc0, params)
        counts = batch_counts(batch)
        grads = {k: torch.zeros_like(v) for k, v in p0.items()}
        total = 0.0
        for ex in batch:
            parts: dict = {}
            loss = utterance_loss(llm, enc, config, ex, counts, prec, parts)
            if t == 1:
                out["rows1"].append(parts.get("fd", 0.0))
            g = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            for (k, acc), gi in zip(grads.items(), g):
                if gi is not None:
                    acc += gi
            total += float(loss.detach())
        out["loss"].append(total)
        if t == 1:
            out["grad1"] = {k: g.clone() for k, g in grads.items()}
        lr = lr_at(t - 1)
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m[k].mul_(b1).add_((1.0 - b1) * g)
                v2[k].mul_(b2).add_((1.0 - b2) * g.square())
                p.sub_(lr * (m[k] / c1) / (torch.sqrt(v2[k] / c2) + eps))
    out["params"] = {k: p.detach() for k, p in params.items()}
    return out


def leaf_norm_gaps(got: Dict[str, float], ref: Dict[str, float],
                   keep: List[str]) -> Tuple[float, str]:
    """The worst leaf's |got norm - reference norm| over the larger of the
    leaf's reference norm and the median leaf's, over ``keep``, with the
    leaf it was found on."""
    vals = sorted(ref[k] for k in keep)
    mid = vals[len(vals) // 2]
    gaps = sorted((abs(got[k] - ref[k]) / max(ref[k], mid, 1e-30), k) for k in keep)
    return gaps[-1]
