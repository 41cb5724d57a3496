"""Training data (port of ``data/``): the batch container, collation, the
synthetic and HF-disk datasets and the lazy raw readers of the
preprocessing job (``preprocess.py``); ``native.py`` binds the host audio
frontend, ``flac.py`` decodes FLAC in Python and ``audio_io.py`` loads WAV
and FLAC files."""

from .batch import Batch
from .collate import collate_batch, pick_bucket
from .datasets import (
    HFDiskDataset,
    LazyRawView,
    SyntheticSpeechDataset,
    load_librispeech_dir,
    load_training_datasets,
)

__all__ = [
    "Batch",
    "HFDiskDataset",
    "LazyRawView",
    "SyntheticSpeechDataset",
    "collate_batch",
    "load_librispeech_dir",
    "load_training_datasets",
    "pick_bucket",
]
