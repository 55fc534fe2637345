"""Carry-across: an artifact saved by the JAX package loads into the port
and serves the same recommendations, and the port's own artifact loads
back into the JAX package."""

import jax
import numpy as np
import pytest
import torch

from bert4rec_tpu.apps import Recommender as JaxRecommender
from bert4rec_tpu.dataloaders import BERT4RecDataloader as JaxDataloader
from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models import BERT4RecModel as JaxModel
from bert4rec_tpu.models import BERT4RecModelWrapper as JaxWrapper
from bert4rec_tpu_torch.apps import Recommender
from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
from bert4rec_tpu_torch.models import BERT4RecModelWrapper
from bert4rec_tpu_torch.models.model_utils import determine_model_path
from bert4rec_tpu_torch.utils import checkpoint
from tests import test_utils

SEQ, PRED = 20, 4


@pytest.fixture(scope="module", params=[True, False],
                ids=["fused", "unfused"])
def jax_artifact(request, tmp_path_factory):
    """A JAX-saved artifact (random weights, output bias included so the
    logits are tie-free) and the JAX recommender over it."""
    dl = JaxDataloader(max_seq_len=SEQ, max_predictions_per_seq=PRED)
    vocab = test_utils.generate_random_word_list(n_words=40, seed=0)
    dl.generate_vocab(vocab)
    cfg = JaxConfig(vocab_size=dl.tokenizer.get_vocab_size(),
                    hidden_size=32, num_layers=2, num_attention_heads=4,
                    inner_dim=64, max_sequence_length=SEQ,
                    max_predictions_per_seq=PRED,
                    use_fused_layer=request.param)
    model = JaxModel(config=cfg)
    params = model.init(jax.random.key(1))
    rng = np.random.default_rng(1)
    params["mlm"]["output_bias"] = rng.normal(
        size=params["mlm"]["output_bias"].shape).astype(np.float32)
    path = tmp_path_factory.mktemp("jax_artifact")
    JaxWrapper(model, params).save(path, tokenizer=dl.tokenizer, mode=2)
    return path, vocab, JaxRecommender(model, params, dl)


def port_recommender(path, device="cpu"):
    wrapper, extras = BERT4RecModelWrapper.load(path, mode=2, device=device)
    dl = BERT4RecDataloader(SEQ, PRED, tokenizer=extras["tokenizer"])
    return wrapper, Recommender(wrapper.model, wrapper.params, dl,
                                device=device)


def test_jax_artifact_serves_the_same_recommendations(jax_artifact):
    path, vocab, jax_rec = jax_artifact
    wrapper, rec = port_recommender(path)
    assert wrapper.model.config.to_dict() == \
        jax_rec.model.config.to_dict()
    assert wrapper.get_meta()["tokenizer"] == "simple"
    rng = np.random.default_rng(2)
    hs = [[vocab[j] for j in rng.integers(0, 40, size=n)]
          for n in (1, 3, 8, SEQ - 1, SEQ + 5)]
    assert rec.recommend_batch(hs, top_k=5) == \
        jax_rec.recommend_batch(hs, top_k=5)
    for h in hs[:3]:
        assert rec(h) == jax_rec(h)
        assert rec(h, use_mlm_head=False) == jax_rec(h, use_mlm_head=False)


def test_params_carry_across_unchanged(jax_artifact):
    path, _, jax_rec = jax_artifact
    wrapper, _ = port_recommender(path)
    ours = checkpoint.params_to_numpy(wrapper.params)
    theirs = {k: np.asarray(v)
              for k, v in checkpoint.flatten(jax_rec.params).items()}
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_port_artifact_loads_into_jax(jax_artifact, tmp_path):
    path, vocab, jax_rec = jax_artifact
    wrapper, rec = port_recommender(path)
    out = wrapper.save(tmp_path / "port", tokenizer=rec.dataloader.tokenizer,
                       mode=2)
    back, extras = JaxWrapper.load(out, mode=2)
    assert extras["tokenizer"].get_vocab() == \
        rec.dataloader.tokenizer.get_vocab()
    flat = checkpoint.flatten(back.params)
    for k, v in checkpoint.params_to_numpy(wrapper.params).items():
        np.testing.assert_array_equal(np.asarray(flat[k]), v, err_msg=k)
    dl = JaxDataloader(max_seq_len=SEQ, max_predictions_per_seq=PRED,
                       tokenizer=extras["tokenizer"])
    hs = [vocab[:4], vocab[10:12]]
    assert JaxRecommender(back.model, back.params, dl).recommend_batch(
        hs, top_k=3) == rec.recommend_batch(hs, top_k=3)


def test_load_rejects_a_checkpoint_missing_a_leaf(jax_artifact, tmp_path):
    path, _, _ = jax_artifact
    wrapper, _ = port_recommender(path)
    params = checkpoint.params_to_numpy(wrapper.params)
    del params["encoder/pooler/bias"]
    broken = tmp_path / "broken"
    wrapper.save(broken, mode=2)
    checkpoint.save_pytree(broken / "weights.npz",
                           checkpoint.unflatten(params))
    with pytest.raises(KeyError):
        BERT4RecModelWrapper.load(broken, mode=2, device="cpu")


def test_save_refuses_without_params_and_resolves_paths(tmp_path,
                                                        monkeypatch):
    wrapper = BERT4RecModelWrapper(None)
    with pytest.raises(RuntimeError):
        wrapper.save(tmp_path / "x", mode=2)
    monkeypatch.setenv("BERT4REC_TPU_HOME", str(tmp_path))
    assert determine_model_path("m", 0) == tmp_path / "saved_models" / "m"
    assert determine_model_path("/abs/m", 0) == \
        determine_model_path("/abs/m", 2)
    with pytest.raises(ValueError):
        determine_model_path("m", 7)


def test_recommend_stream_matches_recommend_batch(jax_artifact):
    path, vocab, _ = jax_artifact
    _, rec = port_recommender(path)
    batches = [[vocab[:3], vocab[5:9]], [vocab[20:30]]]
    for workers in (0, 2):
        assert list(rec.recommend_stream(batches, top_k=4,
                                         fetch_workers=workers)) == \
            [rec.recommend_batch(b, top_k=4) for b in batches]


def test_unknown_item_ids_are_refused_on_the_host(jax_artifact):
    path, vocab, _ = jax_artifact
    _, rec = port_recommender(path)
    with pytest.raises(ValueError):
        rec.recommend_batch([vocab[:2] + ["never-seen-item"]], top_k=2)
    assert isinstance(rec._dispatch_topk([vocab[:2]], 2), torch.Tensor)
