"""The port's example flows (``bert4rec_tpu_torch/examples``) run end to
end on the CPU as ``python -m`` scripts with ``--device cpu``, as
``tests/test_examples.py`` runs the JAX package's: save / load and a
resumed training run, the Ranker app, and the serving export (fp32 and
int8 artifacts, an ``ArtifactRecommender`` behind the service)."""

import pathlib
import subprocess
import sys

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
