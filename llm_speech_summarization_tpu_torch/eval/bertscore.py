"""BERTScore: contextual-embedding summary similarity (Zhang et al., 2020);
port of ``eval/bertscore.py``.

The algorithm (greedy cosine matching with optional IDF weighting) is
float64 numpy, a copy of the JAX package's; the contextual embedder is
pluggable. The default embedder, ``LlamaEmbedder``, is a hidden layer of
the framework's own LLM (no pretrained BERT is needed): with random
weights the scores are only internally consistent, with converted weights
they are a quality signal. Its forward is the port's ``llama_forward``,
whose attention is kernel B1 on the card (a left-pad window).

Algorithm (per candidate/reference pair):
  sim[i, j] = cos(cand_emb[i], ref_emb[j])
  recall    = Σ_j w_j · max_i sim[i, j] / Σ_j w_j     (w = IDF or 1)
  precision = Σ_i w_i · max_j sim[i, j] / Σ_i w_i
  F1        = 2PR / (P + R)
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# An embedder maps texts → per-text (token_embeddings (T, D), token_ids).
Embedder = Callable[[Sequence[str]], List[Tuple[np.ndarray, List[int]]]]


def _normalize(emb: np.ndarray) -> np.ndarray:
    emb = emb.astype(np.float64)
    norms = np.linalg.norm(emb, axis=-1, keepdims=True)
    return emb / np.maximum(norms, 1e-12)


def _idf_weights(ref_token_ids: List[List[int]]) -> Dict[int, float]:
    """Smoothed IDF over the reference corpus (the original paper's scheme):
    idf(t) = log((N + 1) / (df(t) + 1))."""
    n = len(ref_token_ids)
    df: Counter = Counter()
    for ids in ref_token_ids:
        df.update(set(ids))
    return {t: math.log((n + 1) / (d + 1)) for t, d in df.items()}


def pair_bert_score(
    cand_emb: np.ndarray,
    ref_emb: np.ndarray,
    cand_w: Optional[np.ndarray] = None,
    ref_w: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Greedy-matching P/R/F1 for one (candidate, reference) embedding pair."""
    if cand_emb.shape[0] == 0 or ref_emb.shape[0] == 0:
        return {"precision": 0.0, "recall": 0.0, "f1": 0.0}
    sim = _normalize(cand_emb) @ _normalize(ref_emb).T  # (Tc, Tr)
    cw = np.ones(sim.shape[0]) if cand_w is None else np.asarray(cand_w, np.float64)
    rw = np.ones(sim.shape[1]) if ref_w is None else np.asarray(ref_w, np.float64)
    p = float((sim.max(axis=1) * cw).sum() / max(cw.sum(), 1e-12))
    r = float((sim.max(axis=0) * rw).sum() / max(rw.sum(), 1e-12))
    f = 2 * p * r / (p + r) if (p + r) else 0.0
    return {"precision": p, "recall": r, "f1": f}


def bert_score(
    candidates: Sequence[str],
    references: Sequence[str],
    embedder: Embedder,
    idf: bool = False,
) -> Dict[str, float]:
    """Corpus-mean BERTScore P/R/F1.

    ``embedder`` is called once over candidates and once over references
    (implementations batch internally). ``idf=True`` weights tokens by
    smoothed inverse document frequency computed over the references.
    """
    assert len(candidates) == len(references)
    if not candidates:
        return {"precision": 0.0, "recall": 0.0, "f1": 0.0}
    cands = embedder(list(candidates))
    refs = embedder(list(references))

    idf_map: Optional[Dict[int, float]] = (
        _idf_weights([ids for _, ids in refs]) if idf else None
    )

    def weights(ids: List[int]) -> Optional[np.ndarray]:
        if idf_map is None:
            return None
        w = np.asarray([idf_map.get(t, math.log(len(refs) + 1)) for t in ids])
        # tiny corpora degenerate: with N references where every token
        # appears in all of them, idf = log((N+1)/(N+1)) = 0 for ALL
        # tokens (guaranteed at N=1) and recall/f1 would report 0.0
        # regardless of similarity — fall back to uniform weighting
        if w.size and not w.any():
            return None
        return w

    ps, rs, fs = [], [], []
    for (ce, cids), (re_, rids) in zip(cands, refs):
        s = pair_bert_score(ce, re_, weights(cids), weights(rids))
        ps.append(s["precision"])
        rs.append(s["recall"])
        fs.append(s["f1"])
    return {
        "precision": float(np.mean(ps)),
        "recall": float(np.mean(rs)),
        "f1": float(np.mean(fs)),
    }


class LlamaEmbedder:
    """Contextual token embeddings from a hidden layer of the framework LLM.

    One forward per batch of ``batch_size`` rows (the last batch padded with
    empty rows), left-padded to a 64-multiple length, without gradients, on
    the parameters' device. ``layer`` indexes the HF-style hidden_states
    stack (0 = the embeddings, i = block i's output); the default is a
    mid-stack layer, which BERTScore's own tuning found more correlated
    with human judgment than the final one.
    """

    def __init__(self, llm_params, llm_cfg, tokenizer, layer: Optional[int] = None,
                 max_tokens: int = 256, batch_size: int = 16):
        self.params = llm_params
        self.cfg = llm_cfg
        self.tokenizer = tokenizer
        self.layer = layer if layer is not None else llm_cfg.num_layers // 2
        self.max_tokens = max_tokens
        self.batch_size = batch_size

    def __call__(self, texts: Sequence[str]) -> List[Tuple[np.ndarray, List[int]]]:
        import torch

        from ..models.llama import llama_forward

        device = self.params["final_norm"].device
        all_ids = [self.tokenizer.encode(t, add_bos=False)[: self.max_tokens] for t in texts]
        out: List[Tuple[np.ndarray, List[int]]] = []
        for i in range(0, len(all_ids), self.batch_size):
            chunk = all_ids[i: i + self.batch_size]
            B = self.batch_size
            L = max(max((len(x) for x in chunk), default=1), 1)
            L = ((L + 63) // 64) * 64
            ids = np.zeros((B, L), np.int32)
            mask = np.zeros((B, L), bool)
            for b, x in enumerate(chunk):  # left pad
                if x:
                    ids[b, L - len(x):] = x
                    mask[b, L - len(x):] = True
            with torch.no_grad():
                res = llama_forward(self.params, self.cfg,
                                    input_ids=torch.from_numpy(ids).to(device),
                                    attn_mask=torch.from_numpy(mask).to(device),
                                    return_hidden=True, compute_logits=False)
                hid = res.hidden_states[self.layer].float().cpu().numpy()
            for b, x in enumerate(chunk):
                out.append((hid[b, L - len(x):] if x else hid[b, :0], list(x)))
        return out
