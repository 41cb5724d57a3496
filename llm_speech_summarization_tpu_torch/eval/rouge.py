"""ROUGE metrics for summary quality (port of ``eval/rouge.py``, a copy:
pure Python).

ROUGE-1/2/L (F1, with precision and recall) after the standard Lin (2004)
definitions, with the usual lowercase + alphanumeric tokenization; no rouge
package is needed.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Sequence

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


def _f1(matches: float, pred_count: int, ref_count: int) -> Dict[str, float]:
    p = matches / pred_count if pred_count else 0.0
    r = matches / ref_count if ref_count else 0.0
    f = 2 * p * r / (p + r) if (p + r) else 0.0
    return {"precision": p, "recall": r, "f1": f}


def rouge_n(prediction: str, reference: str, n: int = 1) -> Dict[str, float]:
    pred = _tokenize(prediction)
    ref = _tokenize(reference)
    pred_ngrams = Counter(tuple(pred[i : i + n]) for i in range(len(pred) - n + 1))
    ref_ngrams = Counter(tuple(ref[i : i + n]) for i in range(len(ref) - n + 1))
    matches = sum((pred_ngrams & ref_ngrams).values())
    return _f1(matches, sum(pred_ngrams.values()), sum(ref_ngrams.values()))


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l(prediction: str, reference: str) -> Dict[str, float]:
    pred = _tokenize(prediction)
    ref = _tokenize(reference)
    lcs = _lcs_len(pred, ref)
    return _f1(lcs, len(pred), len(ref))


def rouge_scores(predictions: Sequence[str], references: Sequence[str]) -> Dict[str, float]:
    """Corpus-level mean ROUGE-1/2/L F1 over aligned prediction/reference pairs."""
    assert len(predictions) == len(references)
    if not predictions:
        return {"rouge1": 0.0, "rouge2": 0.0, "rougeL": 0.0}
    n = len(predictions)
    return {
        "rouge1": sum(rouge_n(p, r, 1)["f1"] for p, r in zip(predictions, references)) / n,
        "rouge2": sum(rouge_n(p, r, 2)["f1"] for p, r in zip(predictions, references)) / n,
        "rougeL": sum(rouge_l(p, r)["f1"] for p, r in zip(predictions, references)) / n,
    }
