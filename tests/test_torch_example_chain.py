"""The port's example flows held against the JAX package on the CPU, on
one ``tools/synth_corpus.py`` ML-1M corpus (the dataset's exact on-disk
format) under the record cap, both packages pointed at it:

- data: ``dataloader_usage_example``'s vocabulary size, split sizes, first
  ``batches(256, seed=0)`` batch and inference features equal JAX's
  ``generate_vocab`` / ``prepare_training`` / ``batches`` bit for bit;
  ``temporal_features_example``'s batch and features equal JAX's temporal
  pipeline's on the same frame (keys, shapes, padding alignment, values);
- JAX -> port: on an artifact saved by JAX's ``BERT4RecModelWrapper.save``
  (S=200, hidden 32, random weights), JAX's evaluation flow and the port's
  ``bert4rec_evaluation_example`` give the same ranks (host negatives from
  one seed: metrics within 1e-6, the same ``eval_results.json`` keys), and
  the port's ``recommender_app_example`` JAX's ``Recommender``'s items
  wherever adjacent scores lie more than 1e-5 apart;
- port -> JAX: the artifact the port's ``bert4rec_ml_1m_example`` saves
  loads in JAX's ``BERT4RecModelWrapper.load``, and JAX's forward on a test
  batch matches the port's within 1e-5.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4rec_tpu import datasets as jax_datasets
from bert4rec_tpu.apps import Recommender as JaxRecommender
from bert4rec_tpu.dataloaders import BERT4RecDataloader as JaxDataloader
from bert4rec_tpu.dataloaders import get_dataloader_factory as jax_factory
from bert4rec_tpu.dataloaders import preprocessors as jax_preprocessors
from bert4rec_tpu.evaluation import BERT4RecEvaluator as JaxEvaluator
from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models import BERT4RecModel as JaxModel
from bert4rec_tpu.models import BERT4RecModelWrapper as JaxWrapper
from bert4rec_tpu_torch import datasets
from bert4rec_tpu_torch.apps import Recommender
from bert4rec_tpu_torch.dataloaders import get_dataloader_factory
from bert4rec_tpu_torch.evaluation import BERT4RecEvaluator
from bert4rec_tpu_torch.examples import (
    bert4rec_evaluation_example, bert4rec_ml_1m_example,
    dataloader_usage_example, recommender_app_example,
    temporal_features_example,
)
from bert4rec_tpu_torch.models import BERT4RecModelWrapper
from examples import bert4rec_evaluation_example as jax_evaluation_example
from test_torch_example_flows import ml1m_home  # noqa: F401 (a fixture)

FEATURES = ("input_word_ids", "input_mask", "masked_lm_positions")
EVAL_SEED = 7
SCORE_GAP = 1e-5


@pytest.fixture
def corpus(ml1m_home, monkeypatch):  # noqa: F811
    """Both packages read the synthetic ML-1M under the record cap and
    save under its home."""
    monkeypatch.setenv("BERT4REC_TPU_HOME", str(ml1m_home))
    monkeypatch.setenv("BERT4REC_TPU_LOAD_N_RECORDS", "8000")
    monkeypatch.setenv("BERT4REC_TPU_EXAMPLE_EPOCHS", "1")
    for cls in (datasets.ML1M, jax_datasets.ML1M):
        monkeypatch.setattr(cls, "dest", ml1m_home / "data" / "ml-1m")
    return ml1m_home


def assert_batches_equal(ours: dict, theirs: dict) -> None:
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_dataloader_usage_matches_jax(corpus):
    ours = dataloader_usage_example.main(device="cpu")
    loader = jax_factory("bert4rec").create_ml_1m_dataloader()
    loader.generate_vocab()
    assert ours["vocab_size"] == loader.get_tokenizer().get_vocab_size()
    train, val, test = loader.prepare_training(finetuning_split=0.1)
    assert ours["sizes"] == (len(train), len(val), len(test))
    assert_batches_equal(ours["batch"],
                         next(train.batches(batch_size=256, seed=0)))
    assert_batches_equal(ours["inference"], loader.prepare_inference(
        loader.create_item_list()[:5]))


def test_temporal_features_match_jax():
    ours = temporal_features_example.main(device="cpu")
    df = temporal_features_example.interactions()

    class InlineSource:
        @classmethod
        def load_data(cls):
            return df

    loader = JaxDataloader(
        max_seq_len=16, max_predictions_per_seq=4, data_source=InlineSource,
        preprocessor=jax_preprocessors.BERT4RecTemporalPreprocessor)
    loader.generate_vocab(sorted(set(df["item"])))
    train, _, _ = loader.get_data(
        sort_by="timestamp", group_by="uid",
        extract_data=["item", "timestamp"], finetuning_split=0.1)
    batch = next(train.batches(8, seed=0))
    assert_batches_equal(ours["batch"], batch)
    pad = batch["input_word_ids"] == 0
    assert (ours["batch"]["input_timestamps"][pad] == 0).all()
    # single-sequence features: the [UNK] slot's time is the clock's
    user = df[df.uid == 0].sort_values("timestamp")
    theirs = loader.preprocessor.prepare_inference(
        user["item"].tolist(), user["timestamp"].tolist())
    assert sorted(ours["inference"]) == sorted(theirs)
    for k, v in theirs.items():
        assert ours["inference"][k].shape == v.shape, k
        if k != "input_timestamps":
            np.testing.assert_array_equal(ours["inference"][k], v)
    for flag in ("use_temporal_embeddings", "use_temporal_attention"):
        assert ours[flag].shape == (8, 4, loader.tokenizer.get_vocab_size())
        assert np.isfinite(ours[flag]).all()


@pytest.fixture
def jax_artifact(corpus, tmp_path):
    """A small random-weight model saved by JAX (S=200, hidden 32) with
    the JAX dataloader's tokenizer, in the artifact layout of
    ``save(mode=2)``."""
    loader = jax_factory("bert4rec").create_ml_1m_dataloader()
    loader.generate_vocab()
    tokenizer = loader.get_tokenizer()
    model = JaxModel(config=JaxConfig(
        vocab_size=tokenizer.get_vocab_size(), hidden_size=32, num_layers=2,
        num_attention_heads=4, inner_dim=64, max_sequence_length=200,
        max_predictions_per_seq=40))
    path = tmp_path / "jax_model"
    JaxWrapper(model, model.init(jax.random.key(0))).save(
        path, tokenizer=tokenizer, mode=2)
    return path


def test_evaluation_example_on_a_jax_artifact(jax_artifact, monkeypatch):
    """Host negatives from one seed on both sides: the same ranks, so the
    same metrics."""
    monkeypatch.setattr(jax_evaluation_example, "BERT4RecEvaluator",
                        functools.partial(JaxEvaluator, seed=EVAL_SEED,
                                          device_negatives=False))
    jax_evaluation_example.main(str(jax_artifact))
    with open(jax_artifact / "eval_results.json") as f:
        theirs = json.load(f)
    monkeypatch.setattr(bert4rec_evaluation_example, "BERT4RecEvaluator",
                        functools.partial(BERT4RecEvaluator, seed=EVAL_SEED,
                                          device_negatives=False))
    ours = bert4rec_evaluation_example.main(str(jax_artifact), device="cpu")
    with open(jax_artifact / "eval_results.json") as f:
        written = json.load(f)
    assert sorted(written) == sorted(theirs) == sorted(ours)
    assert theirs["Valid Ranks"] > 0
    for k, v in theirs.items():
        assert abs(ours[k] - v) <= 1e-6, (k, ours[k], v)
        assert abs(written[k] - v) <= 1e-6, (k, written[k], v)


def separated_ranks(scores: np.ndarray, k: int) -> list:
    """Ranks r < k of the best-first ``scores`` whose neighbours lie more
    than ``SCORE_GAP`` away on both sides."""
    top = np.sort(scores)[::-1][:k + 1]
    gaps = -np.diff(top)
    return [r for r in range(k)
            if gaps[r] > SCORE_GAP and (r == 0 or gaps[r - 1] > SCORE_GAP)]


def test_recommender_example_on_a_jax_artifact(jax_artifact):
    ours = recommender_app_example.main(str(jax_artifact), device="cpu")
    history = ours["history"]
    wrapper, extras = JaxWrapper.load(jax_artifact)
    loader = jax_factory("bert4rec").create_ml_1m_dataloader(
        tokenizer=extras["tokenizer"])
    theirs = JaxRecommender(wrapper.model, wrapper.params, loader)
    # JAX's masked-slot scores, seen items and special tokens excluded
    feats = loader.prepare_inference(history)
    logits = np.asarray(wrapper.model.apply(
        wrapper.params, {k: jnp.asarray(feats[k]) for k in FEATURES}
    )["mlm_logits"][0, 0], np.float64)
    tok = loader.tokenizer
    logits[tok.tokenize(history)] = -np.inf
    logits[list(wrapper.model.special_token_ids)] = -np.inf
    k = 10
    checked = separated_ranks(logits, k)
    assert 0 in checked
    assert ours["recommendation"] == theirs(history)
    restored, port_extras = BERT4RecModelWrapper.load(jax_artifact,
                                                      device="cpu")
    ranked_ours = Recommender(
        restored.model, restored.params,
        get_dataloader_factory("bert4rec").create_ml_1m_dataloader(
            tokenizer=port_extras["tokenizer"]),
        device="cpu").recommend_batch([history], top_k=k)[0]
    ranked_theirs = theirs.recommend_batch([history], top_k=k)[0]
    for r in checked:
        assert ranked_ours[r] == ranked_theirs[r], (r, ranked_ours,
                                                    ranked_theirs)


def test_jax_loads_the_ml1m_example_artifact(corpus):
    _, metrics, history = bert4rec_ml_1m_example.main(device="cpu")
    assert np.isfinite(history.history["loss"]).all()
    path = corpus / "saved_models" / "bert4rec_ml-1m_128"
    with open(path / "eval_results.json") as f:
        assert sorted(json.load(f)) == sorted(metrics)
    theirs, jextras = JaxWrapper.load(path)
    ours, extras = BERT4RecModelWrapper.load(path, device="cpu")
    assert jextras["tokenizer"].get_vocab() == extras["tokenizer"].get_vocab()
    assert theirs.get_meta()["trained_on_dataset"] == "ml_1m"
    loader = jax_factory("bert4rec").create_ml_1m_dataloader(
        tokenizer=jextras["tokenizer"])
    _, _, test = loader.prepare_training(finetuning_split=0.1)
    batch = next(test.batches(16, shuffle=False))
    want = np.asarray(theirs.model.apply(
        theirs.params, {k: jnp.asarray(batch[k]) for k in FEATURES}
    )["mlm_logits"])
    with torch.inference_mode():
        got = ours.model.apply(
            ours.params, {k: torch.from_numpy(batch[k]) for k in FEATURES}
        )["mlm_logits"].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
