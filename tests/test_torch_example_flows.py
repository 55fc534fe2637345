"""The port's example flows (``bert4rec_tpu_torch/examples``, the
counterparts of the JAX package's ``examples/``) run end to end on the CPU
as ``python -m ... --device cpu`` subprocesses, as ``tests/test_examples.py``
runs JAX's: the self-contained ones as they are, the corpus-backed ones on
a ``tools/synth_corpus.py`` corpus (the dataset's exact on-disk format)
under a throwaway ``BERT4REC_TPU_HOME``, with ``BERT4REC_TPU_LOAD_N_RECORDS
=8000`` and ``BERT4REC_TPU_EXAMPLE_EPOCHS=1``. Each test holds what the
script prints or writes: the metrics' keys, the artifact's files, the
by-hand loss against the library's. The ML-1M chain shares one trained
artifact: train -> evaluate -> recommend -> rank -> serve. The other four
training scripts are in ``test_torch_example_datasets.py`` and
``test_torch_example_reddit.py``."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
METRICS = ["HR@1", "HR@10", "HR@5", "MAP", "NDCG@1", "NDCG@10", "NDCG@5",
           "Valid Ranks"]
ARTIFACT = ["checkpoints", "encoder_config.json", "eval_results.json",
            "meta_config.json", "vocab.txt", "weights.npz"]


def synth_corpus(home, dataset, *extra):
    """``tools/synth_corpus.py``, unchanged, as a tool."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "synth_corpus.py"), "--home",
         str(home), "--dataset", dataset, *extra],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def run(module, *args, cwd, home=None) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # one intra-op thread: the models are tiny, and the suite's workers
    # share the host's cores (threads past them slowed a flow 7x)
    env["OMP_NUM_THREADS"] = "1"
    if home is not None:
        env.update(BERT4REC_TPU_HOME=str(home),
                   BERT4REC_TPU_LOAD_N_RECORDS="8000",
                   BERT4REC_TPU_EXAMPLE_EPOCHS="1")
    proc = subprocess.run(
        [sys.executable, "-m", f"bert4rec_tpu_torch.examples.{module}",
         *args, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(cwd), env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def printed(out: str, prefix: str):
    """The Python literal after ``prefix`` on the line that starts so."""
    line = next(ln for ln in out.splitlines() if ln.startswith(prefix))
    return ast.literal_eval(line[len(prefix):].strip())


def metrics_line(out: str) -> dict:
    """The metrics dict a flow prints on a line of its own."""
    line = next(ln for ln in out.splitlines()
                if ln.startswith("{'Valid Ranks'"))
    return ast.literal_eval(line)


def check_metrics(metrics: dict) -> None:
    assert sorted(metrics) == METRICS
    assert metrics["Valid Ranks"] > 0
    assert all(0.0 <= v <= 1.0 for k, v in metrics.items()
               if k != "Valid Ranks")


@pytest.fixture(scope="module")
def ml1m_home(tmp_path_factory):
    home = tmp_path_factory.mktemp("ml1m_home")
    synth_corpus(home, "ml_1m")
    return home


def test_loss_calculation(tmp_path):
    out = run("loss_calculation_example", cwd=tmp_path)
    assert "mlm_logits: (2, 3, 50)" in out
    assert "(over 5 unmasked positions)" in out
    assert abs(printed(out, "manual - library =")) <= 1e-6
    loss = float(out.split("masked SCCE loss =", 1)[1].split()[0])
    assert 0.0 < loss == printed(out, "manual loss      =")


def test_temporal_features(tmp_path):
    out = run("temporal_features_example", cwd=tmp_path)
    keys = printed(out, "feature keys:")
    assert keys == sorted(["input_mask", "input_timestamps",
                           "input_word_ids", "labels", "masked_lm_ids",
                           "masked_lm_positions", "masked_lm_weights"])
    assert "input_timestamps: (8, 16) int64" in out
    assert "timestamps aligned with item padding: OK" in out
    assert "temporal model mlm_logits: (8, 4, 33)" in out
    assert "temporal-attention mlm_logits: (8, 4, 33)" in out


def test_lifecycle(tmp_path):
    out = run("bert4rec_lifecycle_example", cwd=tmp_path)
    check_metrics(printed(out, "eval:"))
    assert printed(out, "history:") == [f"movie {i}" for i in range(5)]
    rec = out.split("recommendation:", 1)[1].strip()
    assert rec.startswith("movie ") and rec not in printed(out, "history:")


def test_sasrec(tmp_path):
    out = run("sasrec_example", cwd=tmp_path)
    assert "train task: next_item" in out
    assert "causal attention: True" in out
    assert 0.0 <= printed(out, "masked_accuracy:") <= 1.0
    check_metrics(metrics_line(out))
    after = out.split("->", 1)[1].strip()
    assert len(ast.literal_eval(after)) == 3


def test_dataloader_usage(ml1m_home, tmp_path):
    out = run("dataloader_usage_example", cwd=tmp_path, home=ml1m_home)
    assert printed(out, "vocab size:") > 3
    sizes = [int(v) for v in out.split("train/val/test sizes:", 1)[1]
             .splitlines()[0].split()]
    assert sizes[0] > 0 and sizes[1] == sizes[2] > 0
    for key, shape in (("input_word_ids", "(256, 200)"),
                       ("masked_lm_positions", "(256, 40)")):
        assert f"  {key}: {shape} int32" in out
    assert printed(out, "inference features:")["input_word_ids"] == (1, 200)


def test_ml1m_chain(ml1m_home, tmp_path):
    """Train on the synthetic ML-1M, then drive every consumer of the
    saved artifact: evaluation, the Recommender, the Ranker, the HTTP
    server's demo request."""
    out = run("bert4rec_ml_1m_example", cwd=tmp_path, home=ml1m_home)
    check_metrics(metrics_line(out))
    saved = ml1m_home / "saved_models" / "bert4rec_ml-1m_128"
    assert sorted(p.name for p in saved.iterdir()) == ARTIFACT
    assert (saved / "checkpoints" / "best.npz").is_file()
    with open(saved / "eval_results.json") as f:
        check_metrics(json.load(f))
    with open(saved / "meta_config.json") as f:
        meta = json.load(f)
    assert meta["trained_on_dataset"] == "ml_1m" and meta["EPOCHS"] == 1

    out = run("bert4rec_evaluation_example", cwd=tmp_path, home=ml1m_home)
    check_metrics(metrics_line(out))
    # JAX's flow writes the results beside the working directory's path
    with open(tmp_path / "bert4rec_ml-1m_128" / "eval_results.json") as f:
        check_metrics(json.load(f))

    out = run("recommender_app_example", cwd=tmp_path, home=ml1m_home)
    history = printed(out, "history:")
    rec = out.split("recommendation:", 1)[1].strip()
    assert len(history) == 3 and rec not in history

    out = run("ranker_app", "bert4rec_ml-1m_128", cwd=tmp_path,
              home=ml1m_home)
    lines = out.splitlines()
    assert lines[-2].startswith("The item '") and " was ranked " in lines[-2]
    assert sorted(r for _, r in ast.literal_eval(lines[-1])) == [1, 2, 3]

    out = run("serving_server_example", "bert4rec_ml-1m_128", "0", "demo",
              cwd=tmp_path, home=ml1m_home)
    body = ast.literal_eval(out.split("->", 1)[1].splitlines()[0].strip())
    assert len(body["items"]) == 5
    health = printed(out, "healthz:")
    assert health["requests"] == 1 and health["errors"] == 0
