"""Whole CPU runs with the timed path broken underneath: each fault a
training cell can have must turn ``correct`` false (the look for a chip
is skipped; everything else runs as on the card)."""

import pytest

from benchmark.tests import tiny


def _unchanged(monkeypatch):
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer

    def apply(self, grads):       # the step leaves its state as it was
        self.state["step"] += 1
    monkeypatch.setattr(BERT4RecTrainer, "_apply", apply)


def _half_batch(monkeypatch):
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer
    original = BERT4RecTrainer._loss_and_logs

    def half(self, params, batch, training, seed):
        rows = batch["input_word_ids"].shape[0] // 2
        return original(self, params, {k: v[:rows] for k, v in
                                       batch.items()}, training, seed)
    monkeypatch.setattr(BERT4RecTrainer, "_loss_and_logs", half)


@pytest.mark.parametrize("cell", ["ml20m_128.train", "bert_base_512.train"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_a_broken_step_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    code, line, err = tiny.run_cell(cell)
    assert code == 0, err[-2000:]
    assert line["correct"] is False, line["checks"]


def test_the_sound_step_is_correct():
    code, line, err = tiny.run_cell("bert_base_512.train", seed=77)
    assert code == 0 and line["correct"] is True, line["checks"]
