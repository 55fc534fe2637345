"""The port's tokenizer and inference preprocessing held against the JAX
package's: the same histories must give byte-identical features."""

import numpy as np
import pytest

from bert4rec_tpu.dataloaders import BERT4RecDataloader as JaxDataloader
from bert4rec_tpu.tokenizers import SimpleTokenizer as JaxTokenizer
from bert4rec_tpu_torch import tokenizers
from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
from bert4rec_tpu_torch.tokenizers import SimpleTokenizer, tokenizer_utils
from tests import test_utils

MAX_SEQ_LEN, MAX_PRED = 24, 5


def loaders(vocab):
    ours = BERT4RecDataloader(MAX_SEQ_LEN, MAX_PRED)
    theirs = JaxDataloader(max_seq_len=MAX_SEQ_LEN,
                           max_predictions_per_seq=MAX_PRED)
    ours.generate_vocab(vocab)
    theirs.generate_vocab(vocab)
    return ours, theirs


def histories(vocab, seed=0):
    rng = np.random.default_rng(seed)
    lengths = [1, 2, MAX_SEQ_LEN - 1, MAX_SEQ_LEN, MAX_SEQ_LEN + 7, 60]
    lengths += list(rng.integers(1, 40, size=6))
    return [[vocab[j] for j in rng.integers(0, len(vocab), size=n)]
            for n in lengths]


def assert_byte_identical(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for key in theirs:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


class TestInferenceFeatures:

    @pytest.mark.parametrize("native", ["1", "0"],
                             ids=["native_engine", "numpy_engine"])
    def test_batch_features_byte_identical(self, native, monkeypatch):
        # both JAX masking engines take the same deterministic branch for
        # finetuning rows; check the port against each
        monkeypatch.setenv("BERT4REC_TPU_NATIVE", native)
        vocab = test_utils.generate_random_word_list(n_words=50, seed=1)
        ours, theirs = loaders(vocab)
        hs = histories(vocab)
        assert_byte_identical(ours.prepare_inference_batch(hs),
                              theirs.prepare_inference_batch(hs))

    def test_single_history_features_byte_identical(self):
        vocab = test_utils.generate_random_word_list(n_words=30, seed=2)
        ours, theirs = loaders(vocab)
        for h in histories(vocab, seed=3):
            assert_byte_identical(ours.prepare_inference(h),
                                  theirs.prepare_inference(h))

    def test_last_slot_is_the_masked_unk_placeholder(self):
        vocab = test_utils.generate_random_word_list(n_words=30, seed=4)
        ours, _ = loaders(vocab)
        feats = ours.prepare_inference_batch([vocab[:3], vocab[:40]])
        pos = feats["masked_lm_positions"][:, 0]
        np.testing.assert_array_equal(pos, [3, MAX_SEQ_LEN - 1])
        assert (feats["input_word_ids"][[0, 1], pos] == 1).all()  # [MASK]
        assert (feats["masked_lm_ids"][:, 0] == 2).all()          # [UNK]
        assert feats["masked_lm_weights"].sum() == 2

    def test_rejects_non_list_history(self):
        ours, _ = loaders(["a", "b"])
        with pytest.raises(ValueError):
            ours.prepare_inference("a")
        with pytest.raises(ValueError):
            ours.prepare_inference_batch([("a",)])


class TestTokenizer:

    def test_ids_and_vocab_file_match_jax(self, tmp_path):
        words = test_utils.generate_random_word_list(n_words=40, seed=5)
        stream = np.asarray([words[i] for i in np.random.default_rng(0)
                             .integers(0, 40, size=300)], dtype=object)
        ours, theirs = SimpleTokenizer(), JaxTokenizer()
        np.testing.assert_array_equal(ours.tokenize(stream),
                                      theirs.tokenize(stream))
        assert ours.tokenize(words[:7]) == theirs.tokenize(words[:7])
        assert ours.tokenize("new-item") == theirs.tokenize("new-item")
        ours.export_vocab_to_file(tmp_path / "ours.txt")
        theirs.export_vocab_to_file(tmp_path / "theirs.txt")
        assert (tmp_path / "ours.txt").read_bytes() \
            == (tmp_path / "theirs.txt").read_bytes()
        back = tokenizers.get("simple")
        back.import_vocab_from_file(tmp_path / "theirs.txt")
        assert back.get_vocab() == theirs.get_vocab()
        assert back.detokenize([0, 5, 10**6]) == \
            theirs.detokenize([0, 5, 10**6])

    def test_non_extensible_and_null_items_raise(self):
        tok = SimpleTokenizer(extensible=False)
        with pytest.raises(RuntimeError):
            tok.tokenize("unknown")
        with pytest.raises(ValueError):
            SimpleTokenizer().tokenize(np.asarray(["a", None], dtype=object))
        with pytest.raises(ValueError):
            tokenizers.get("nope")

    def test_num_vocab_file_roundtrip(self, tmp_path):
        path = tmp_path / "num.txt"
        tokenizer_utils.export_num_vocab_to_file(path, [3, 1, 4])
        assert tokenizer_utils.import_num_vocab_from_file(path) == [3, 1, 4]
