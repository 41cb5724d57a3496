"""Training data (port of ``data/``): the batch container, collation, the
synthetic and HF-disk datasets; ``native.py`` binds the host audio
frontend."""

from .batch import Batch
from .collate import collate_batch, pick_bucket
from .datasets import HFDiskDataset, SyntheticSpeechDataset, load_training_datasets

__all__ = [
    "Batch",
    "HFDiskDataset",
    "SyntheticSpeechDataset",
    "collate_batch",
    "load_training_datasets",
    "pick_bucket",
]
