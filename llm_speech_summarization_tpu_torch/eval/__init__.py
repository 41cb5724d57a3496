"""Evaluation (port of ``eval/``): ROUGE, BERTScore with the framework LLM
as its embedder, and the engine's quality and latency harness."""

from .bertscore import LlamaEmbedder, bert_score, pair_bert_score
from .rouge import rouge_l, rouge_n, rouge_scores

__all__ = [
    "LlamaEmbedder",
    "bert_score",
    "pair_bert_score",
    "rouge_l",
    "rouge_n",
    "rouge_scores",
]
