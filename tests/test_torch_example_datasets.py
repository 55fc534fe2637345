"""The port's per-dataset training examples for Beauty, Steam and ML-20M
(``bert4rec_tpu_torch/examples/bert4rec_<dataset>_example.py``) run end to
end on the CPU as ``python -m ... --device cpu`` subprocesses, each on a
``tools/synth_corpus.py`` corpus in its dataset's exact on-disk format
(``--small`` for ML-20M) under a throwaway ``BERT4REC_TPU_HOME``, with
``BERT4REC_TPU_LOAD_N_RECORDS=8000`` and ``BERT4REC_TPU_EXAMPLE_EPOCHS=1``,
as ``tests/test_examples.py`` runs JAX's: each prints its test metrics,
writes ``eval_results.json`` and saves the artifact under
``saved_models/``. ML-1M's is in ``test_torch_example_flows.py``, with the
chain over its artifact; Reddit's, the slowest on the CPU (6 steps of
S=200), in ``test_torch_example_reddit.py``."""

import json

import pytest

from test_torch_example_flows import (
    ARTIFACT, check_metrics, metrics_line, run, synth_corpus,
)

SAVED = {"beauty": "bert4rec_beauty_128", "steam": "bert4rec_steam_128",
         "ml_20m": "bert4rec_ml-20m_128", "reddit": "bert4rec_reddit_128"}
SMALL = ("ml_20m", "reddit")   # synth_corpus.py --small


def train_and_check(dataset, tmp_path):
    home = tmp_path / "home"
    synth_corpus(home, dataset, *(("--small",) if dataset in SMALL else ()))
    out = run(f"bert4rec_{dataset}_example", cwd=tmp_path, home=home)
    check_metrics(metrics_line(out))
    assert "epoch 1/1: " in out
    saved = home / "saved_models" / SAVED[dataset]
    assert sorted(p.name for p in saved.iterdir()) == ARTIFACT
    with open(saved / "eval_results.json") as f:
        check_metrics(json.load(f))
    with open(saved / "meta_config.json") as f:
        meta = json.load(f)
    assert meta["trained_on_dataset"] == dataset
    assert meta["tokenizer"] == "simple"


@pytest.mark.parametrize("dataset", ["beauty", "ml_20m", "steam"])
def test_training_example(dataset, tmp_path):
    train_and_check(dataset, tmp_path)
