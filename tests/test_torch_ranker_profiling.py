"""The port's ``apps.Ranker`` and ``utils.profiling`` held against the JAX
package on the CPU: the same params and history give the same full-vocab
rank and candidate order (the MLM head and the tied fallback, on tie-free
logits), the evaluator's tie law; ``StepTimer.summary`` equals JAX's on the
same recorded seconds; ``trace`` and ``train(profile_dir=...)`` write a
trace file."""

import contextlib
import json

import jax
import numpy as np
import pytest
import torch

from bert4rec_tpu.apps import Ranker as JaxRanker
from bert4rec_tpu.dataloaders import BERT4RecDataloader as JaxDataloader
from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models import BERT4RecModel as JaxModel
from bert4rec_tpu.utils import profiling as jax_profiling
from bert4rec_tpu_torch.apps import Ranker
from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
from bert4rec_tpu_torch.utils import StepTimer, checkpoint, hard_sync, trace
from tests import test_utils
from tests.test_torch_trainer import dataset, host_params, jax_trainer, \
    port_trainer

SEQ, PRED = 12, 3


@pytest.fixture(scope="module", params=[0, 8], ids=["plain_vocab",
                                                   "padded_vocab"])
def rankers(request):
    """JAX's Ranker and the port's over the same params (a random output
    bias, so the logits are tie-free); ``vocab_pad_to`` 8 pads the table,
    whose padding columns the fallback must knock out."""
    vocab = test_utils.generate_random_word_list(n_words=30, seed=0)
    jdl = JaxDataloader(max_seq_len=SEQ, max_predictions_per_seq=PRED)
    jdl.generate_vocab(vocab)
    pdl = BERT4RecDataloader(SEQ, PRED)
    pdl.generate_vocab(vocab)
    kw = dict(vocab_size=jdl.tokenizer.get_vocab_size(), hidden_size=16,
              num_layers=2, num_attention_heads=2, inner_dim=32,
              max_sequence_length=SEQ, max_predictions_per_seq=PRED)
    if request.param:
        kw["vocab_pad_to"] = request.param
    jmodel = JaxModel(config=JaxConfig(**kw))
    params = jmodel.init(jax.random.key(3))
    rng = np.random.default_rng(3)
    params["mlm"]["output_bias"] = rng.normal(
        size=params["mlm"]["output_bias"].shape).astype(np.float32)
    flat = {k: np.asarray(v) for k, v in checkpoint.flatten(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    port = Ranker(BERT4RecModel(config=BERT4RecConfig(**kw)),
                  checkpoint.params_from_numpy(flat, "cpu"), pdl,
                  device="cpu")
    return JaxRanker(jmodel, params, jdl), port, vocab


class TestRanker:

    @pytest.mark.parametrize("use_mlm_head", [True, False],
                             ids=["mlm_head", "tied_fallback"])
    @pytest.mark.parametrize("target", [0, 7, 19, 29])
    def test_rank_equals_jax(self, rankers, target, use_mlm_head):
        jr, pr, vocab = rankers
        history = vocab[:5]
        ours = pr(history, rank_item=vocab[target],
                  use_mlm_head=use_mlm_head)
        theirs = jr(history, rank_item=vocab[target],
                    use_mlm_head=use_mlm_head)
        assert ours == theirs
        assert 1 <= ours[0] <= pr.model.config.vocab_size

    @pytest.mark.parametrize("use_mlm_head", [True, False],
                             ids=["mlm_head", "tied_fallback"])
    def test_candidate_order_equals_jax(self, rankers, use_mlm_head):
        jr, pr, vocab = rankers
        candidates = vocab[8:20]
        ours = pr(vocab[2:9], rank_items=candidates,
                  use_mlm_head=use_mlm_head)
        assert ours == jr(vocab[2:9], rank_items=candidates,
                          use_mlm_head=use_mlm_head)
        assert [r for _, r in ours] == list(range(1, len(candidates) + 1))

    def test_rank_counts_ties_against_the_target(self, rankers):
        """The evaluator's law: 1 + the items whose logit ties or beats
        the target's. With every logit equal, the rank is the vocab."""
        _, pr, vocab = rankers
        flat = checkpoint.flatten(pr.params)
        params = checkpoint.unflatten({k: torch.zeros_like(v)
                                       for k, v in flat.items()})
        cfg = pr.model.config
        tied = Ranker(pr.model, params, pr.dataloader, device="cpu")
        rank, text = tied(vocab[:4], rank_item=vocab[6])
        assert rank == cfg.vocab_size   # padding columns score -1e9
        assert vocab[6] in text

    def test_requires_target(self, rankers):
        _, pr, vocab = rankers
        with pytest.raises(ValueError, match="rank_item"):
            pr(vocab[:5])


class TestProfiling:

    @pytest.mark.parametrize("skip", [0, 1, 3])
    def test_step_timer_summary_equals_jax(self, skip):
        seconds = [0.5, 0.0123, 0.0101, 0.0099, 0.0250, 0.0111]
        ours, theirs = StepTimer(256), jax_profiling.StepTimer(256)
        for t in seconds:
            ours.record(t)
            theirs.record(t)
        assert ours.summary(skip) == theirs.summary(skip)
        ours.reset()
        assert ours.summary() == {"steps": 0} == \
            jax_profiling.StepTimer(1).summary()
        with ours.step():
            hard_sync({"a": torch.ones(2), "b": [torch.zeros(1)]})
        assert ours.summary()["steps"] == 1

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with trace(tmp_path / "t"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        files = list((tmp_path / "t").glob("trace_*.json"))
        assert len(files) == 1
        events = json.loads(files[0].read_text())["traceEvents"]
        assert any("mm" in e.get("name", "") for e in events)
        with trace(None), trace(tmp_path / "u", enabled=False):
            pass
        assert not (tmp_path / "u").exists()

    @pytest.mark.parametrize("trainer_kw", [{}, {"grad_accum_steps": 2}],
                             ids=["single", "accumulated"])
    def test_train_profile_dir_captures_steps_after_the_first(
            self, tmp_path, trainer_kw, monkeypatch):
        """``train(profile_dir=...)`` traces optimizer steps [1, 1 +
        profile_steps) of the call, as JAX's capture: one trace file, its
        window opened before step 1 and closed before step 1 +
        profile_steps."""
        from bert4rec_tpu_torch.trainers import bert4rec_trainer as bt
        windows = []
        real = bt.profiling.trace

        @contextlib.contextmanager
        def recording(log_dir, enabled=True):
            windows.append(trainer.state["step"])
            with real(log_dir, enabled):
                yield
            windows.append(trainer.state["step"])

        monkeypatch.setattr(bt.profiling, "trace", recording)
        trainer = port_trainer(host_params(jax_trainer()),
                               trainer_kw=trainer_kw)
        trainer.train(dataset(), epochs=2, batch_size=8, steps_per_epoch=3,
                      verbose=False, profile_dir=tmp_path / "prof",
                      profile_steps=2)
        assert trainer.state["step"] == 6
        assert windows == [1, 3]
        assert len(list((tmp_path / "prof").glob("trace_*.json"))) == 1
