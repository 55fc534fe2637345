"""The port's example flows (``bert4rec_tpu_torch/examples``) run end to
end on the CPU as ``python -m`` scripts with ``--device cpu``, as
``tests/test_examples.py`` runs the JAX package's: save / load and a
resumed training run, the Ranker app, the serving export (fp32 and
int8 artifacts, an ``ArtifactRecommender`` behind the service), and the
multi-process training and sharded ranking on two gloo CPU ranks."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def run(module, *args) -> str:
    out = subprocess.run(
        [sys.executable, "-m", f"bert4rec_tpu_torch.examples.{module}",
         *args, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


def test_save_and_load():
    out = run("save_and_load")
    assert "restored model config == True" in out
    assert "identical outputs: True" in out
    assert "'rng'" in out and "opt_state/1/0" in out
    assert "resumed at epoch 3: step 6, seed 7" in out


def test_ranker_app():
    lines = run("ranker_app").splitlines()
    assert lines[0].startswith("The item 'Synthetic Feature No. 00010' "
                               "was ranked ")
    assert sorted(r for _, r in eval(lines[1])) == [1, 2, 3]


def test_serving_export(tmp_path):
    out = run("serving_export", "--out", str(tmp_path))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["bert4rec_recommend.pt2", "bert4rec_topk.int8.pt2",
                     "bert4rec_topk.pt2"]
    sizes = {p.name: p.stat().st_size for p in tmp_path.iterdir()}
    assert sizes["bert4rec_topk.int8.pt2"] < sizes["bert4rec_topk.pt2"]
    assert "batch up to 12200" in out
    rows = [ln for ln in out.splitlines() if ln.startswith("batch ")]
    assert len(rows) == 2 and rows[0].split(":")[1] == rows[1].split(":")[1]
    recommended = eval(out.split("recommended: ", 1)[1].splitlines()[0])
    assert len(recommended) == 3 and all(
        r.startswith("Synthetic Feature No.") for r in recommended)


@pytest.mark.parametrize("mp", [1, 2])
def test_multihost_example(tmp_path, mp):
    """Two gloo ranks train on their 'data' slices ((2, 1)) or share one
    slice over a vocab-sharded table ((1, 2)): every rank reports the same
    global loss."""
    out = run("multihost_example", "--ranks", "2", "--model-parallelism",
              str(mp), "--sequences", "64", "--batch-size", "16",
              "--epochs", "1", "--hidden", "32", "--vocab-size", "200",
              "--out", str(tmp_path))
    shape = {"data": 2 // mp, "model": mp}
    assert out.count(f"mesh {shape}") == 2
    losses = [ln for ln in out.splitlines() if ln.startswith("final loss")]
    assert len(losses) == 2 and losses[0] == losses[1]
    rows = [int(np.load(tmp_path / f"train.rank{r}.npz")["rows"])
            for r in range(2)]
    assert rows == [64, 64]


def test_sharded_ranking_example(tmp_path):
    """rank_top_k over two vocab shards gives the dense ranking's top-k,
    as tests/test_end_to_end.py asserts for JAX."""
    out = run("sharded_ranking_example", "--ranks", "2", "--vocab-size",
              "5000", "--hidden", "32", "--seq", "16", "--out",
              str(tmp_path))
    assert out.count("table block (2560, 32) of 5120 rows") == 2
    for r in range(2):
        res = np.load(tmp_path / f"rank.rank{r}.npz")
        np.testing.assert_array_equal(res["top_ids"], res["dense_ids"])
        np.testing.assert_allclose(res["top_probs"], res["dense_probs"],
                                   rtol=1e-5)
        assert res["top_ids"].shape == (4, 2, 10)
        assert not np.isin(res["top_ids"], [0, 1, 2]).any()
