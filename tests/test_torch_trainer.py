"""The port's trainer (bert4rec_tpu_torch/trainers) held against the JAX
package's ``BERT4RecTrainer`` on the CPU: the same params, the same
``ProcessedDataset`` numpy batches, the fused layer and fused loss at
rate 0 (so the JAX Pallas kernels run in interpret mode and the port's
plain versions run): loss and both metrics per step, params after three
steps, validation; then the port's own laws — ``steps_per_call`` equals
single steps, ``grad_accum_steps`` equals the big batch, a resumed run
equals the uninterrupted one bit for bit (dropout on), and the
callbacks."""

import json

import jax
import numpy as np
import pytest
import torch

from bert4rec_tpu.dataloaders.processed_dataset import (
    MaskingConfig, ProcessedDataset,
)
from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models import BERT4RecModel as JaxModel
from bert4rec_tpu.trainers import BERT4RecTrainer as JaxTrainer
from bert4rec_tpu.trainers import optimizers as jax_opt
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
from bert4rec_tpu_torch.trainers import (
    BERT4RecTrainer, EarlyStopping, JSONLLogger, get, optimizers,
)
from bert4rec_tpu_torch.utils.checkpoint import flatten, params_from_numpy
from tests import test_utils

V = 60
OPT = dict(init_lr=1e-2, num_warmup_steps=2, num_train_steps=100)


def config_kwargs(**over):
    kw = dict(vocab_size=V, hidden_size=32, num_layers=2,
              num_attention_heads=4, inner_dim=64, max_sequence_length=16,
              max_predictions_per_seq=4, attention_dropout=0.0,
              output_dropout=0.0, use_fused_layer=True, use_fused_loss=True)
    kw.update(over)
    return kw


def dataset(n=64, seed=0):
    seqs = test_utils.generate_tokenized_dataset(
        n_sequences=n, min_len=4, max_len=16, vocab_size=V, seed=seed)
    cfg = MaskingConfig(max_seq_len=16, max_predictions_per_seq=4,
                        mask_token_id=1, pad_token_id=0, unk_token_id=2,
                        masked_lm_rate=0.3)
    return ProcessedDataset(seqs, cfg, lambda: V)


def jax_trainer(**over):
    trainer = JaxTrainer(JaxModel(config=JaxConfig(**config_kwargs(**over))))
    trainer.initialize_model(optimizer=jax_opt.create_adam_w_optimizer(**OPT),
                             rng=jax.random.key(0))
    return trainer


def port_trainer(params, trainer_kw=None, **over):
    trainer = BERT4RecTrainer(
        BERT4RecModel(config=BERT4RecConfig(**config_kwargs(**over))),
        **(trainer_kw or {}))
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(**OPT),
        params=params_from_numpy(params, "cpu"), device="cpu")
    return trainer


def host_params(trainer):
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in flatten(trainer.state["params"]).items()}


@pytest.fixture(scope="module")
def jax_run():
    """Three single-step epochs of the JAX trainer, and its init params."""
    trainer = jax_trainer()
    init = host_params(trainer)
    hist = trainer.train(dataset(), epochs=3, batch_size=16,
                         steps_per_epoch=1, verbose=False)
    return init, hist.history, host_params(trainer), trainer


class TestAgainstJaxTrainer:

    def test_step_logs_and_params_match(self, jax_run):
        init, jhist, jparams, _ = jax_run
        trainer = port_trainer(init)
        hist = trainer.train(dataset(), epochs=3, batch_size=16,
                             steps_per_epoch=1, verbose=False)
        assert trainer.state["step"] == 3
        # each epoch is one step, so these are per-step logs. loss: fp32
        # sums in another order; the metrics count argmax hits over the
        # same tie-free logits, so they are equal
        np.testing.assert_allclose(hist.history["loss"], jhist["loss"],
                                   rtol=1e-5)
        for k in ("masked_accuracy", "accuracy"):
            np.testing.assert_allclose(hist.history[k], jhist[k], atol=1e-7)
        # Adam divides by sqrt(v) + 1e-6: a gradient difference d moves a
        # param by up to about lr * d / 1e-6 where |g| ~ eps; at lr 1e-2
        # and fp32 gradient differences ~1e-9 that is ~1e-5
        ours = host_params(trainer)
        for k, v in jparams.items():
            np.testing.assert_allclose(ours[k], v, rtol=0, atol=2e-5,
                                       err_msg=k)
        assert max(np.abs(jparams[k] - init[k]).max() for k in init) > 1e-3

    def test_validate_matches_jax(self, jax_run):
        _, _, jparams, jtrainer = jax_run
        trainer = port_trainer(jparams)
        val = dataset(n=40, seed=3)   # 40 rows: the last batch is padded
        ours = trainer.validate(val, batch_size=16)
        theirs = jtrainer.validate(val, batch_size=16)
        assert set(ours) == set(theirs)
        for k in ours:
            assert ours[k] == pytest.approx(theirs[k], rel=1e-5, abs=1e-7)


class TestPortLaws:

    def test_steps_per_call_equals_single_steps(self):
        init = host_params(jax_trainer())
        runs = []
        for k in (1, 2):
            # dropout on: the unfused path on the CPU, seeded per step
            trainer = port_trainer(init, dict(steps_per_call=k),
                                   attention_dropout=0.2, output_dropout=0.5)
            hist = trainer.train(dataset(), epochs=1, batch_size=16,
                                 verbose=False)
            runs.append((hist.history, host_params(trainer),
                         trainer.state["step"]))
        (h1, p1, s1), (h2, p2, s2) = runs
        assert s1 == s2 == 4
        for k in ("loss", "masked_accuracy", "accuracy"):
            assert h1[k] == h2[k]
        for k in p1:
            np.testing.assert_array_equal(p1[k], p2[k])

    def test_grad_accum_equals_the_big_batch(self):
        init = host_params(jax_trainer())
        accum = port_trainer(init, dict(grad_accum_steps=2))
        accum.train(dataset(), epochs=1, batch_size=8, steps_per_epoch=2,
                    verbose=False)
        big = port_trainer(init)
        big.train(dataset(), epochs=1, batch_size=16, steps_per_epoch=2,
                  verbose=False)
        assert accum.state["step"] == big.state["step"] == 2
        pa, pb = host_params(accum), host_params(big)
        # the n_valid-weighted mean of two microbatch gradients is the big
        # batch's gradient up to fp32 summation order (then Adam, as above)
        for k in pa:
            np.testing.assert_allclose(pa[k], pb[k], rtol=0, atol=2e-5,
                                       err_msg=k)

    def test_modes_are_exclusive(self):
        with pytest.raises(ValueError):
            BERT4RecTrainer(None, steps_per_call=2, grad_accum_steps=2)

    def test_resume_is_exact(self, tmp_path):
        init = host_params(jax_trainer())
        drop = dict(attention_dropout=0.2, output_dropout=0.5)
        val = dataset(n=20, seed=5)
        whole = port_trainer(init, **drop)
        whole.train(dataset(), epochs=2, batch_size=16, steps_per_epoch=2,
                    verbose=False)
        path = tmp_path / "state.npz"
        first = port_trainer(init, **drop)
        first.train(dataset(), val, checkpoint_path=path, epochs=1,
                    batch_size=16, steps_per_epoch=2, verbose=False)
        resumed = port_trainer(init, **drop)
        resumed.train(dataset(), val, checkpoint_path=path, epochs=2,
                      batch_size=16, steps_per_epoch=2, verbose=False)
        assert whole.state["step"] == resumed.state["step"] == 4
        assert resumed.state["opt_state"]["count"] == 4
        pw, pr = host_params(whole), host_params(resumed)
        for k in pw:
            np.testing.assert_array_equal(pw[k], pr[k])

    def test_checkpoint_round_trip(self, tmp_path):
        trainer = port_trainer(host_params(jax_trainer()))
        trainer.train(dataset(), epochs=1, batch_size=16, steps_per_epoch=1,
                      verbose=False)
        trainer._epochs_completed, trainer._best_monitor_value = 1, 0.25
        trainer.save_checkpoint(tmp_path / "c.npz")
        other = port_trainer(host_params(jax_trainer()))
        other.load_checkpoint(tmp_path / "c.npz")
        assert (other.state["step"], other.state["seed"],
                other._epochs_completed, other._best_monitor_value) == \
            (1, 0, 1, 0.25)
        a, b = flatten(trainer.state), flatten(other.state)
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k]) and b[k].requires_grad == \
                    a[k].requires_grad, k


class TestCallbacksAndFactory:

    def test_early_stopping_and_jsonl_logger(self, tmp_path):
        trainer = port_trainer(host_params(jax_trainer()))
        trainer.append_callback(JSONLLogger(tmp_path / "log.jsonl"))
        # min_delta 100: only the first epoch counts as an improvement
        stop = EarlyStopping(monitor="loss", patience=1, mode="min",
                             min_delta=100.0, restore_best_weights=True)
        trainer.append_callback(stop)
        hist = trainer.train(dataset(), epochs=5, batch_size=16,
                             steps_per_epoch=1, verbose=False)
        lines = [json.loads(ln) for ln in
                 (tmp_path / "log.jsonl").read_text().splitlines()]
        assert [ln["epoch"] for ln in lines] == \
            list(range(1, len(hist.history["loss"]) + 1))
        assert {"loss", "masked_accuracy", "accuracy",
                "examples_per_second"} <= set(lines[0])
        # so it stops after patience (1) more epoch and puts back the
        # state of the first epoch's end
        assert stop.stop_training and len(lines) == 2
        assert trainer.state["step"] == 1

    def test_get_factory(self):
        trainer = get("bert4rec", model=None)
        assert isinstance(trainer, BERT4RecTrainer)
        assert get(trainer) is trainer
        with pytest.raises(ValueError):
            get("nope")
