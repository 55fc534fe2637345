"""Whole CPU runs of the moonlight_5L cell at the tiny size with the timed
path broken underneath: an unchanged step, a half batch, a router that
selects without its bias and one that takes the top 5 and a random expert
must each turn ``correct`` false; the sound step is correct."""

import pytest
import torch

from benchmark.tests import tiny

CELL = "moonlight_5L.train"


def _unchanged(monkeypatch):
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer

    def apply(self, grads):
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


def _router(monkeypatch, pick):
    from bert4rec_tpu_torch.models.components import mla_moe
    original = mla_moe.route

    def route(p, h, bias, cfg):
        sel, w, scores = original(p, h, bias, cfg)
        sel = pick(scores, bias, cfg.num_experts_per_tok)
        w = scores.gather(1, sel)
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return sel, w * cfg.routed_scaling_factor, scores
    monkeypatch.setattr(mla_moe, "route", route)


def _without_bias(monkeypatch):
    _router(monkeypatch, lambda s, b, k: torch.topk(s, k, -1).indices)


def _top5_and_random(monkeypatch):
    gen = torch.Generator().manual_seed(0)

    def pick(s, b, k):
        order = torch.argsort(s + b, -1, descending=True)
        at = torch.randint(k, s.shape[-1], (s.shape[0], 1), generator=gen)
        return torch.cat([order[:, :k - 1], order.gather(1, at)], -1)
    _router(monkeypatch, pick)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _without_bias,
                                   _top5_and_random])
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    code, line, err = tiny.run_cell(CELL)
    assert code == 0, err[-2000:]
    assert line["correct"] is False, line["checks"]


def test_the_sound_step_is_correct_and_counts_its_rows():
    code, line, err = tiny.run_cell(CELL, seed=2 ** 33 + 77)
    assert code == 0 and line["correct"] is True, line["checks"]
    routing = line["routing"]
    assert routing["dropped_rows"] == 0
    assert routing["routed_rows"] == line["attempted"] * 8 * 24 * 6
