"""The port's SASRec family held against the JAX package on the CPU: the
next-item features and the ``"next_item"`` ProcessedDataset batches byte
for byte for one seed, the ``"sasrec"`` preprocessor through a dataloader,
the model's construction rules, ``loss_and_metrics`` and train steps at a
small width (fp32, dropout 0, fused layer and loss on their plain
versions against JAX's interpret kernels), and a JAX-saved SASRec
artifact loading into the port and ranking the same items."""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from bert4rec_tpu.dataloaders import BERT4RecDataloader as JaxDataloader
from bert4rec_tpu.dataloaders import dataloader_utils as jax_utils
from bert4rec_tpu.dataloaders.processed_dataset import (
    MaskingConfig as JaxMaskingConfig,
    ProcessedDataset as JaxProcessedDataset,
)
from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models import BERT4RecModelWrapper as JaxWrapper
from bert4rec_tpu.models import SASRecModel as JaxSASRec
from bert4rec_tpu.trainers import BERT4RecTrainer as JaxTrainer
from bert4rec_tpu.trainers import optimizers as jax_opt
from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
from bert4rec_tpu_torch.dataloaders import dataloader_utils as utils
from bert4rec_tpu_torch.dataloaders import preprocessors
from bert4rec_tpu_torch.dataloaders.processed_dataset import (
    MaskingConfig, ProcessedDataset,
)
from bert4rec_tpu_torch.models import (
    BERT4RecConfig, BERT4RecModel, BERT4RecModelWrapper, Bert4RecEncoder,
    SASRecModel,
)
from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
from bert4rec_tpu_torch.utils.checkpoint import flatten, params_from_numpy
from tests import test_utils
from tests.test_torch_model import random_params, to_jax

V, SEQ, PRED = 43, 16, 4


def padded(rng, n, s=SEQ, min_len=0):
    """``[n, s]`` right-padded ids and their lengths: 0, 1, s and random
    lengths in between."""
    lengths = rng.integers(min_len, s + 1, size=n)
    lengths[:3] = [min_len, max(min_len, 1), s][:min(3, n)]
    ids = rng.integers(3, V, size=(n, s)).astype(np.int32)
    ids *= (np.arange(s)[None, :] < lengths[:, None])
    return ids, lengths.astype(np.int32)


def assert_features_equal(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


class TestNextItemFeatures:

    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("ft_share", [0.0, 0.5, 1.0])
    def test_byte_identical_to_jax(self, seed, ft_share):
        rng = np.random.default_rng(seed)
        ids, lengths = padded(rng, 40)
        ft = rng.random(40) < ft_share
        assert_features_equal(
            utils.next_item_features(ids, lengths, PRED, 0, finetuning=ft),
            jax_utils.next_item_features(ids, lengths, PRED, 0,
                                         finetuning=ft))

    def test_basic_law(self):
        """Every position < len-1 predicts its successor; the final item
        leaves the input; over budget the LAST P positions survive."""
        ids = np.zeros((2, SEQ), np.int32)
        ids[0, :5] = [10, 11, 12, 13, 14]
        ids[1, :7] = [10, 11, 12, 13, 14, 15, 16]
        f = utils.next_item_features(ids, np.array([5, 7]), 4, 0)
        np.testing.assert_array_equal(f["input_word_ids"][0, :5],
                                      [10, 11, 12, 13, 0])
        np.testing.assert_array_equal(f["masked_lm_positions"],
                                      [[0, 1, 2, 3], [2, 3, 4, 5]])
        np.testing.assert_array_equal(f["masked_lm_ids"],
                                      [[11, 12, 13, 14], [13, 14, 15, 16]])


def masking_configs():
    kw = dict(max_seq_len=SEQ, max_predictions_per_seq=PRED,
              mask_token_id=1, pad_token_id=0, unk_token_id=2)
    return MaskingConfig(**kw), JaxMaskingConfig(**kw)


class TestNextItemDataset:

    @pytest.mark.parametrize("chunk", [None, 32], ids=["whole", "chunked"])
    def test_batches_byte_identical_to_jax(self, chunk):
        """Rows longer than S (a fresh crop per epoch), finetuning rows
        (the tail window, one prediction), lengths 1 and 2."""
        seqs = test_utils.generate_tokenized_dataset(
            n_sequences=90, min_len=1, max_len=2 * SEQ, vocab_size=V, seed=3)
        ft = np.random.default_rng(4).random(90) < 0.3
        ours_cfg, jax_cfg = masking_configs()
        ours = ProcessedDataset(seqs, ours_cfg, lambda: V, finetuning=ft,
                                task="next_item")
        theirs = JaxProcessedDataset(seqs, jax_cfg, lambda: V,
                                     finetuning=ft, task="next_item")
        got = list(ours.batches(16, seed=7, chunk_size=chunk))
        want = list(theirs.batches(16, seed=7, chunk_size=chunk))
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert_features_equal(a, b)

    def test_task_survives_subset_concat_and_shard(self):
        ours_cfg, _ = masking_configs()
        ds = ProcessedDataset([np.arange(3, 9, dtype=np.int32)] * 4,
                              ours_cfg, lambda: V, task="next_item")
        assert ds.select([0, 2]).task == "next_item"
        assert ds.concatenate(ds.select([1])).task == "next_item"
        assert ds.shard_for_process(0, 2).task == "next_item"
        with pytest.raises(ValueError, match="Unknown task"):
            ProcessedDataset([np.arange(3, 6)], ours_cfg, lambda: V,
                             task="causal_lm")


def inline_frame(seed=0, users=40):
    rng = np.random.default_rng(seed)
    rows = []
    for uid in range(users):
        cur, t = int(rng.integers(0, 30)), int(rng.integers(1e9, 2e9))
        for _ in range(int(rng.integers(6, 24))):
            rows.append((uid, f"item_{cur}", t))
            cur = (cur + int(rng.integers(1, 4))) % 30
            t += 3600
    return pd.DataFrame(rows, columns=["uid", "item", "timestamp"])


def sasrec_loaders():
    df = inline_frame()

    class Source:
        @classmethod
        def load_data(cls):
            return df.copy()

    kw = dict(max_seq_len=SEQ, max_predictions_per_seq=PRED,
              data_source=Source, preprocessor="sasrec")
    ours, theirs = BERT4RecDataloader(**kw), JaxDataloader(**kw)
    items = sorted(set(df["item"]))
    for dl in (ours, theirs):
        dl.generate_vocab(items)
    return ours, theirs, items


class TestSASRecPreprocessor:

    def test_factory(self):
        pre = preprocessors.get("sasrec")
        assert isinstance(pre, preprocessors.SASRecPreprocessor)
        assert pre._TASK == "next_item"

    def test_dataloader_splits_byte_identical_to_jax(self):
        ours, theirs, _ = sasrec_loaders()
        kw = dict(sort_by="timestamp", group_by="uid", extract_data=["item"],
                  finetuning_split=0.1)
        got, want = ours.get_data(**kw), theirs.get_data(**kw)
        for a, b in zip(got, want):
            assert a.task == b.task == "next_item"
            for x, y in zip(a.batches(8, seed=1), b.batches(8, seed=1)):
                assert_features_equal(x, y)

    def test_inference_slot_at_the_last_history_position(self):
        ours, theirs, items = sasrec_loaders()
        f = ours.prepare_inference(items[:3])
        assert f["masked_lm_weights"][0].sum() == 1
        assert f["masked_lm_positions"][0, 0] == 2
        assert f["input_mask"].sum() == 3
        hs = [items[:3], items[2:9], items[:1], (items * 2)[:SEQ + 5]]
        assert_features_equal(ours.prepare_inference_batch(hs),
                              theirs.prepare_inference_batch(hs))
        assert_features_equal(ours.prepare_inference(items[:5]),
                              theirs.prepare_inference(items[:5]))


def config_kwargs(**over):
    kw = dict(vocab_size=V, hidden_size=32, num_layers=2,
              num_attention_heads=4, inner_dim=64, max_sequence_length=SEQ,
              max_predictions_per_seq=PRED, attention_dropout=0.0,
              output_dropout=0.0)
    kw.update(over)
    return kw


class TestSASRecModel:

    def test_construction_rules(self):
        model = SASRecModel(config=BERT4RecConfig(**config_kwargs()))
        assert model.config.causal_attention
        assert model.encoder.config.causal_attention
        bidirectional = Bert4RecEncoder(BERT4RecConfig(**config_kwargs()))
        with pytest.raises(ValueError, match="causal"):
            SASRecModel(encoder=bidirectional)
        with pytest.raises(ValueError, match="encoder or a config"):
            SASRecModel()
        causal = Bert4RecEncoder(BERT4RecConfig(
            **config_kwargs(causal_attention=True)))
        assert SASRecModel(encoder=causal).encoder is causal

    @pytest.mark.parametrize("fused", [True, False],
                             ids=["fused", "unfused"])
    def test_loss_and_metrics_match_jax(self, fused):
        kw = config_kwargs(use_fused_layer=fused, use_fused_loss=fused)
        jmodel = JaxSASRec(config=JaxConfig(**kw))
        flat = random_params(jmodel, 3)
        ours_cfg, jax_cfg = masking_configs()
        seqs = test_utils.generate_tokenized_dataset(
            n_sequences=8, min_len=3, max_len=SEQ, vocab_size=V, seed=5)
        batch = JaxProcessedDataset(seqs, jax_cfg, lambda: V,
                                    task="next_item").materialize(0)
        jloss, jlogs = jmodel.loss_and_metrics(to_jax(flat), batch)
        model = SASRecModel(config=BERT4RecConfig(**kw))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss, logs = model.loss_and_metrics(params_from_numpy(flat, "cpu"),
                                            tb)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for k in ("masked_accuracy", "accuracy"):
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                       atol=1e-7)

    def test_train_steps_match_jax(self):
        """Three steps of each trainer from the same params on the same
        next-item batches: per-step loss and metrics, then the params."""
        kw = config_kwargs(use_fused_layer=True, use_fused_loss=True)
        opt = dict(init_lr=1e-2, num_warmup_steps=2, num_train_steps=100)
        jt = JaxTrainer(JaxSASRec(config=JaxConfig(**kw)))
        jt.initialize_model(optimizer=jax_opt.create_adam_w_optimizer(**opt),
                            rng=jax.random.key(0))
        init = {k: np.asarray(v) for k, v in flatten(jt.params).items()}
        seqs = test_utils.generate_tokenized_dataset(
            n_sequences=48, min_len=3, max_len=SEQ, vocab_size=V, seed=6)
        ours_cfg, jax_cfg = masking_configs()
        jhist = jt.train(JaxProcessedDataset(seqs, jax_cfg, lambda: V,
                                             task="next_item"),
                         epochs=3, batch_size=16, steps_per_epoch=1,
                         verbose=False).history
        pt = BERT4RecTrainer(SASRecModel(config=BERT4RecConfig(**kw)))
        pt.initialize_model(optimizer=optimizers.create_adam_w_optimizer(
            **opt), params=params_from_numpy(init, "cpu"), device="cpu")
        hist = pt.train(ProcessedDataset(seqs, ours_cfg, lambda: V,
                                         task="next_item"),
                        epochs=3, batch_size=16, steps_per_epoch=1,
                        verbose=False).history
        np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-5)
        for k in ("masked_accuracy", "accuracy"):
            np.testing.assert_allclose(hist[k], jhist[k], atol=1e-7)
        ours = {k: v.detach().numpy()
                for k, v in flatten(pt.state["params"]).items()}
        # the trainer tests' bound: Adam turns fp32 gradient differences
        # of ~1e-9 into param differences of ~1e-5 at lr 1e-2
        for k, v in flatten(jt.params).items():
            np.testing.assert_allclose(ours[k], np.asarray(v), rtol=0,
                                       atol=2e-5, err_msg=k)


class TestPersistence:

    def test_jax_sasrec_artifact_loads_causal_and_ranks_alike(self, tmp_path):
        """A JAX-saved SASRec artifact (``causal_attention: true``) loads
        through the port's wrapper into a causal model, and ``rank_top_k``
        returns JAX's ids on tie-free logits (the output bias spreads
        them)."""
        _, theirs, items = sasrec_loaders()
        kw = config_kwargs(vocab_size=theirs.tokenizer.get_vocab_size(),
                           use_fused_layer=True)
        jmodel = JaxSASRec(config=JaxConfig(**kw))
        flat = random_params(jmodel, 8)
        JaxWrapper(jmodel, to_jax(flat)).save(
            tmp_path / "sasrec", tokenizer=theirs.tokenizer, mode=2)
        wrapper, extras = BERT4RecModelWrapper.load(tmp_path / "sasrec",
                                                    mode=2, device="cpu")
        assert wrapper.model.config.causal_attention
        assert isinstance(wrapper.model, BERT4RecModel)
        hs = [items[:4], items[3:12], items[:1]]
        feats = theirs.prepare_inference_batch(hs)
        exclude = np.where(feats["labels"] > 0, feats["labels"], -1)
        jids, _ = jmodel.rank_top_k(
            to_jax(flat), {k: np.asarray(v) for k, v in feats.items()}, 5,
            exclude=exclude)
        port_dl = BERT4RecDataloader(SEQ, PRED,
                                     tokenizer=extras["tokenizer"],
                                     preprocessor="sasrec")
        ours = port_dl.prepare_inference_batch(hs)
        ids, _ = wrapper.model.rank_top_k(
            wrapper.params, {k: torch.from_numpy(v) for k, v in ours.items()},
            5, exclude=torch.from_numpy(exclude))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
