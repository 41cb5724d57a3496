"""The port's ``Trainer`` on the behaviours ``tests/test_trainer_burrs.py``
holds the JAX trainer to (tiny config, synthetic data, the CPU): the tail
batch of an epoch is trained and a val set smaller than the eval batch
still reports perplexities; a val set smaller than ``val_bs`` is one
batch; the SIGTERM handler is restored when a step cap ends the run; and a
resumed run finishes the configured epochs, no more."""

import signal

import torch

from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.train import Trainer

torch.set_num_threads(1)


def _make_trainer(tmp_path, num_samples, batch_size):
    cfg = load_config(str(YAML_DIR / "tiny_test.yaml"))
    cfg.log.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.log.log_dir = str(tmp_path / "logs")
    cfg.log.num_generate_samples = 0
    cfg.data.synthetic_num_samples = num_samples
    cfg.train.batch_size = batch_size
    cfg.train.steps = None
    cfg.train.epochs = 1
    return cfg, Trainer(cfg, run_name="burrs", device="cpu")


def test_tail_batches_processed_and_small_val_reports_ppl(tmp_path, capsys):
    """7 samples at batch size 4: batches of 4 and 3; the val set (2
    samples) is smaller than the eval batch and still gives perplexities."""
    _, t = _make_trainer(tmp_path, num_samples=7, batch_size=4)
    batches = list(t._batches(t.train_ds, 4, shuffle=False, seed=0))
    assert [b.wav.shape[0] for b in batches] == [4, 3]
    t.validate(epoch=0)
    assert "audio_ppl=" in capsys.readouterr().out


def test_val_smaller_than_val_bs_yields_one_batch(tmp_path):
    _, t = _make_trainer(tmp_path, num_samples=3, batch_size=8)
    batches = list(t._batches(t.val_ds, 8, shuffle=False, seed=0))
    assert len(batches) == 1 and batches[0].wav.shape[0] == len(t.val_ds)


def test_sigterm_handler_restored_after_max_steps_return(tmp_path):
    cfg, t = _make_trainer(tmp_path, num_samples=4, batch_size=2)
    cfg.train.steps = 1  # the early return of the step cap
    before = signal.getsignal(signal.SIGTERM)
    t.train()
    assert t.step == 1
    assert signal.getsignal(signal.SIGTERM) is before


def test_resume_finishes_configured_epochs_not_more(tmp_path):
    cfg, t = _make_trainer(tmp_path, num_samples=4, batch_size=2)
    cfg.train.epochs = 2
    cfg.log.validation_interval = 0  # checkpoints at epoch ends only
    t.train()
    steps_full = t.step
    assert steps_full == 2 * 2  # 2 epochs x 2 batches
    # resuming the finished run: its checkpoint is at the last epoch's end,
    # so at most that epoch again, never the configured epochs more
    t2 = Trainer(cfg, run_name="burrs", device="cpu")
    assert t2.step == steps_full
    t2.train()
    assert t2.step <= steps_full + 2
