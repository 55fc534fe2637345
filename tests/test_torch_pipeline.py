"""The port's host training pipeline (bert4rec_tpu_torch/datasets,
dataloaders, utils/prefetch.py) held against the JAX package's: the same
parsed frames, the same vocabulary in the same order, the same train / val
/ test sequences, and byte-identical batches for one seed with either
masking engine on both sides; the native engine's source is the JAX one,
byte for byte; ``shard_for_process``; the record cap and the data-dir law;
and ``train()`` through the prefetch thread against the same batches fed
without it."""

import pathlib
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch

from bert4rec_tpu import datasets as jax_datasets
from bert4rec_tpu import dataloaders as jax_dataloaders
from bert4rec_tpu.dataloaders import native as jax_native
from bert4rec_tpu_torch import datasets
from bert4rec_tpu_torch import dataloaders
from bert4rec_tpu_torch.dataloaders import native
from bert4rec_tpu_torch.datasets.synthetic import write_ml20m_corpus
from bert4rec_tpu_torch.utils import prefetch as prefetch_lib
from bert4rec_tpu_torch.utils import utils

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def test_masking_source_is_the_jax_source_byte_for_byte():
    ours = pathlib.Path(native.__file__).parent / "masking.cpp"
    theirs = pathlib.Path(jax_native.__file__).parent / "masking.cpp"
    assert ours.read_bytes() == theirs.read_bytes()


def test_native_engine_builds_and_matches_the_jax_engine():
    assert native.available() and jax_native.available()
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 50, size=(9, 12)).astype(np.int32)
    lengths = rng.integers(0, 13, size=9).astype(np.int32)
    ft = np.arange(9) % 4 == 0
    args = (ids, lengths, 4, 1, [2, 0], 50, 1234)
    kw = dict(selection_rate=0.3, mask_token_rate=0.8, random_token_rate=0.1,
              finetuning=ft)
    a = native.apply_dynamic_masking_batch_native(*args, **kw)
    b = jax_native.apply_dynamic_masking_batch_native(*args, **kw)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------- #
# raw datasets
# --------------------------------------------------------------------------- #

@pytest.fixture
def zst_dump(tmp_path):
    import zstandard
    path = tmp_path / "RC_2011-01.zst"
    path.write_bytes(zstandard.ZstdCompressor().compress(
        (FIXTURES / "reddit" / "comments.jsonl").read_bytes()))
    return path


@pytest.mark.parametrize("name,dest", [
    ("ML1M", "ml-1m"), ("ML20M", "ml-20m"), ("Beauty", "beauty.txt"),
    ("Steam", "beauty.txt"), ("Reddit", None)])
@pytest.mark.parametrize("cap", [None, 3])
def test_parsers_match_jax(monkeypatch, zst_dump, name, dest, cap):
    ours, theirs = getattr(datasets, name), getattr(jax_datasets, name)
    path = zst_dump if dest is None else FIXTURES / dest
    frames = []
    for cls in (ours, theirs):
        monkeypatch.setattr(cls, "dest", path)
        monkeypatch.setattr(cls, "load_n_records", cap)
        df = cls.extract_data()
        frames.append(cls.filter_data(df) if name == "Reddit" else df)
    pd.testing.assert_frame_equal(frames[0], frames[1])


def test_data_dir_law(monkeypatch, tmp_path):
    monkeypatch.setenv("BERT4REC_TPU_HOME", str(tmp_path))
    assert utils.get_data_dir() == tmp_path / "data"
    monkeypatch.delenv("BERT4REC_TPU_HOME")
    assert utils.get_data_dir() == \
        pathlib.Path(datasets.__file__).resolve().parents[2] / "data"


def test_corpus_writer_is_the_repo_generators_law(tmp_path, capsys):
    """The port's corpus writer draws the files of ``tools/synth_corpus.py``
    ``make_ml20m`` byte for byte, here at the generator's small size (400
    users over 2,048 movies, no genome filler)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "synth_corpus", FIXTURES.parents[1] / "tools" / "synth_corpus.py")
    synth_corpus = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth_corpus)
    theirs = synth_corpus.make_ml20m(tmp_path / "jax", seed=0, small=True)
    n = write_ml20m_corpus(tmp_path / "port", seed=0, n_users=400,
                           n_movies=2048)
    ours = tmp_path / "port" / "data" / "ml-20m"
    assert sorted(p.name for p in ours.iterdir()) == \
        sorted(p.name for p in theirs.iterdir()) == ["movies.csv",
                                                     "ratings.csv"]
    for name in ("movies.csv", "ratings.csv"):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes()
    assert n == len(pd.read_csv(ours / "ratings.csv"))


def test_size_gate_and_record_cap(monkeypatch, tmp_path):
    """The ±2% gate asks for a download of a small corpus, unless a record
    cap (explicit or ``BERT4REC_TPU_LOAD_N_RECORDS``, resolved per call)
    makes it existence-only. The cap also cuts ``movies.csv``; here it
    exceeds the 200 movies, so every capped rating keeps its movie."""
    write_ml20m_corpus(tmp_path, n_users=30, n_movies=200)
    monkeypatch.setattr(datasets.ML20M, "dest", tmp_path / "data" / "ml-20m")
    assert not datasets.ML20M.is_available()
    monkeypatch.setattr(datasets.ML20M, "download", mock.Mock(
        side_effect=AssertionError("download")))
    with pytest.raises(AssertionError, match="download"):
        datasets.ML20M.load_data()
    monkeypatch.setenv("BERT4REC_TPU_LOAD_N_RECORDS", "1000")
    assert len(datasets.ML20M.load_data()) == 1000
    assert datasets.ML20M.load_n_records is None
    monkeypatch.delenv("BERT4REC_TPU_LOAD_N_RECORDS")
    datasets.ML20M.set_load_n_records(500)
    try:
        assert len(datasets.ML20M.load_data()) == 500
    finally:
        datasets.ML20M.set_load_n_records(None)


# --------------------------------------------------------------------------- #
# prepare_training, in both packages
# --------------------------------------------------------------------------- #

def _prepared(factory, dest_cls, dest, monkeypatch, dataset, **kw):
    monkeypatch.setattr(dest_cls, "dest", dest)
    loader = getattr(factory, f"create_{dataset}_dataloader")(**kw)
    return loader, loader.prepare_training(finetuning_split=0.1)


def _both(monkeypatch, dataset, dest, **kw):
    cls = {"ml_1m": "ML1M", "ml_20m": "ML20M"}[dataset]
    ours = _prepared(dataloaders.get_dataloader_factory(),
                     getattr(datasets, cls), dest, monkeypatch, dataset, **kw)
    theirs = _prepared(jax_dataloaders.get_dataloader_factory(),
                       getattr(jax_datasets, cls), dest, monkeypatch,
                       dataset, **kw)
    return ours, theirs


def _assert_same_batches(a, b, **kw):
    got, want = list(a.batches(**kw)), list(b.batches(**kw))
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        assert x.keys() == y.keys()
        for k in y:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("dataset", ["ml_1m", "ml_20m"])
def test_prepare_training_matches_jax(monkeypatch, tmp_path, dataset,
                                      engine):
    monkeypatch.setenv("BERT4REC_TPU_LOAD_N_RECORDS", "100000")
    monkeypatch.setenv("BERT4REC_TPU_NATIVE",
                       "1" if engine == "native" else "0")
    if dataset == "ml_1m":
        dest, kw = FIXTURES / "ml-1m", {}
    else:
        write_ml20m_corpus(tmp_path, n_users=60, n_movies=400)
        dest = tmp_path / "data" / "ml-20m"
        kw = dict(input_duplication_factor=5, max_seq_len=50)
    (ours, splits), (theirs, jsplits) = _both(monkeypatch, dataset, dest,
                                              **kw)
    assert ours.tokenizer.get_vocab() == theirs.tokenizer.get_vocab()
    if dataset == "ml_20m":
        assert ours.tokenizer.get_vocab_size() == 400 + 3
    for ds, jds in zip(splits, jsplits):
        assert len(ds) == len(jds) > 0
        for s, js in zip(ds.sequences, jds.sequences):
            np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(ds.finetuning, jds.finetuning)
    for seed in (0, 7):
        _assert_same_batches(splits[0], jsplits[0], batch_size=16,
                             seed=seed, drop_remainder=True)
    # chunked streaming: several masking chunks per epoch
    _assert_same_batches(splits[0], jsplits[0], batch_size=8, seed=3,
                         chunk_size=32)
    _assert_same_batches(splits[1], jsplits[1], batch_size=16, seed=1,
                         shuffle=False, pad_final_batch=True)


@pytest.mark.parametrize("index,count", [(0, 1), (1, 3), (2, 3), (3, 4)])
def test_shard_for_process_matches_jax(monkeypatch, tmp_path, index, count):
    monkeypatch.setenv("BERT4REC_TPU_LOAD_N_RECORDS", "100000")
    write_ml20m_corpus(tmp_path, n_users=40, n_movies=300)
    (_, splits), (_, jsplits) = _both(monkeypatch, "ml_20m",
                                      tmp_path / "data" / "ml-20m")
    a = splits[0].shard_for_process(index, count)
    b = jsplits[0].shard_for_process(index, count)
    assert len(a) == len(b) == len(splits[0]) // count
    for s, js in zip(a.sequences, b.sequences):
        np.testing.assert_array_equal(s, js)


def test_shard_for_process_defaults_without_a_process_group(monkeypatch,
                                                            tmp_path):
    monkeypatch.setenv("BERT4REC_TPU_LOAD_N_RECORDS", "100000")
    write_ml20m_corpus(tmp_path, n_users=20, n_movies=100)
    loader = dataloaders.get_dataloader_factory().create_ml_20m_dataloader()
    monkeypatch.setattr(datasets.ML20M, "dest", tmp_path / "data" / "ml-20m")
    train = loader.prepare_training()[0]
    assert not torch.distributed.is_initialized()
    assert len(train.shard_for_process()) == len(train)
    with pytest.raises(ValueError):
        train.shard_for_process(2, 2)


def test_next_item_task_waits_for_the_sasrec_slice():
    """The ``next_item`` task came with the SASRec slice: it runs (the
    final item leaves the input, each position predicts its successor);
    its parity with the JAX package is in tests/test_torch_sasrec.py."""
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset,
    )
    cfg = MaskingConfig(max_seq_len=4, max_predictions_per_seq=2,
                        mask_token_id=1, pad_token_id=0, unk_token_id=2)
    f = ProcessedDataset([np.arange(3, 6)], cfg, lambda: 10,
                         task="next_item").materialize(0)
    np.testing.assert_array_equal(f["input_word_ids"][0], [3, 4, 0, 0])
    np.testing.assert_array_equal(f["input_mask"][0], [1, 1, 0, 0])
    np.testing.assert_array_equal(f["masked_lm_ids"][0], [4, 5])
    with pytest.raises(ValueError, match="Unknown task"):
        ProcessedDataset([np.arange(3, 6)], cfg, lambda: 10, task="nope")


# --------------------------------------------------------------------------- #
# prefetch
# --------------------------------------------------------------------------- #

def test_prefetch_keeps_order_applies_put_and_reraises():
    got = list(prefetch_lib.prefetch(range(200), lambda x: x * 2, depth=3))
    assert got == [2 * x for x in range(200)]

    def boom():
        yield 1
        raise KeyError("producer")

    it = prefetch_lib.prefetch(boom(), None)
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer"):
        next(it)


def test_prefetch_retires_its_thread_when_closed_early():
    import threading
    before = threading.active_count()
    it = prefetch_lib.prefetch(iter(range(10 ** 6)), None, depth=2)
    assert [next(it) for _ in range(5)] == list(range(5))
    it.close()
    assert threading.active_count() == before


def test_device_put_on_the_cpu_wraps_the_arrays():
    put = prefetch_lib.device_put(torch.device("cpu"), ("a",))
    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    out = put({"a": arr, "b": arr})
    assert list(out) == ["a"] and out["a"].dtype == torch.int32
    np.testing.assert_array_equal(out["a"].numpy(), arr)


def test_train_through_prefetch_equals_train_without_it(monkeypatch,
                                                        tmp_path):
    """``train()`` feeding its batches through the prefetch thread ends
    with the same parameters, bit for bit, as feeding the same batches in
    the calling thread."""
    from bert4rec_tpu_torch.config import load_train_config
    from bert4rec_tpu_torch.models import BERT4RecModel
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer
    from bert4rec_tpu_torch.utils.checkpoint import flatten
    monkeypatch.setenv("BERT4REC_TPU_LOAD_N_RECORDS", "100000")
    write_ml20m_corpus(tmp_path, n_users=40, n_movies=120)
    monkeypatch.setattr(datasets.ML20M, "dest", tmp_path / "data" / "ml-20m")
    loader = dataloaders.get_dataloader_factory().create_ml_20m_dataloader(
        max_seq_len=24, max_predictions_per_seq=5, input_duplication_factor=2)
    train_ds, val_ds, _ = loader.prepare_training()

    def run():
        config = load_train_config(
            "ml-20m_64", vocab_size=loader.tokenizer.get_vocab_size(),
            max_sequence_length=24, max_predictions_per_seq=5,
            hidden_size=16, inner_dim=32, num_attention_heads=2)
        trainer = BERT4RecTrainer(BERT4RecModel(config=config))
        trainer.initialize_model(seed=3, device="cpu")
        hist = trainer.train(train_ds, val_ds, epochs=2, batch_size=16,
                             steps_per_epoch=3, seed=5, verbose=False)
        return flatten(trainer.params), hist.history

    threaded, hist = run()
    def inline(it, put, depth=2):
        return (put(b) for b in it)

    with mock.patch.object(prefetch_lib, "prefetch", inline):
        inline, hist_inline = run()
    hist.pop("examples_per_second")              # a wall-clock rate
    hist_inline.pop("examples_per_second")
    assert hist == hist_inline and np.isfinite(hist["loss"]).all()
    assert all(torch.equal(threaded[k], inline[k]) for k in threaded)
