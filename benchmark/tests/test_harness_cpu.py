"""CPU tests of the benchmark: whole runs at a tiny size through the plain
path, the manifest's rules, the operation counts, and the imports."""

import ast
import json
import pathlib
import re
import subprocess
import sys

import pytest

from benchmark import harness, roofline
from benchmark.tests import tiny

ROOT = harness.ROOT
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("kind", sorted(
    p.stem for p in (harness.BENCH / "drivers").glob("[a-z]*.py")))
def test_tiny_run_prints_a_result_line(kind):
    cell = next(w["name"] for w in harness.manifest()["workloads"]
                if harness.load_json(harness.BENCH / "traffic"
                                     / f"{w['traffic']}.json")["kind"]
                == kind)
    code, line, err = tiny.run_cell(cell)
    assert code == 0, err[-2000:]
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, err[-2000:]
    assert "setup_s" in line["metrics"]
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") for s in last)


def test_traced_tiny_run_reports_host_metrics():
    code, line, err = tiny.run_cell("ml20m_128.train", trace=1)
    assert code == 0, err[-2000:]
    assert {"pipeline_ms.train", "dispatch_ms.train"} <= set(line["metrics"])
    # no device trace on the CPU: the device readers report nothing
    assert "device_idle.train" not in line["metrics"]


def test_names_units_and_files():
    groups = [[m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]],
              [w["name"] for w in MAN["workloads"]],
              [c["name"] for c in MAN["configs"]]]
    for names in groups:
        assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(NAME.match(n) for n in sum(groups, []) + [
        t for pair in pairs for t in pair])
    assert all(UNIT.match(m["unit"])
               for m in MAN["end_to_end"] + MAN["per_layer"])
    for c in MAN["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    for m in MAN["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in MAN["workloads"]:
        kind = harness.load_json(harness.BENCH / "traffic"
                                 / f"{w['traffic']}.json")["kind"]
        assert (harness.BENCH / "drivers" / f"{kind}.py").is_file()


def test_every_layer_metric_moves_what_its_cells_report():
    ends = {m["name"]: m for m in MAN["end_to_end"]}
    cells = [w["name"] for w in MAN["workloads"]]
    for m in MAN["per_layer"]:
        moved = ends[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    for cell in cells:
        reported = [e for e in MAN["end_to_end"]
                    if cell in e.get("workloads", cells)]
        assert "setup_s" in [e["name"] for e in reported]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in MAN["per_layer"])


def test_operation_counts_match_the_hand_counts():
    # K1 / K1': 99.1 MFLOP a sequence at H=128, S=200, F=512
    assert roofline.layer_forward_flops(1, 200, 128, 512) == pytest.approx(
        99.1e6, rel=1e-3)
    # one BERT-Base layer a sequence at S=512: 24SH^2 + 4S^2H
    assert roofline.layer_forward_flops(1, 512, 768, 3072) \
        == pytest.approx(8.05e9, rel=1e-3)
    ml20m = harness.load_json(ROOT / "benchmark/configs/ml-20m_128.json")
    base = harness.load_json(ROOT / "benchmark/configs/bert_base_512.json")
    assert roofline.train_step_flops(ml20m["model"], 256) == pytest.approx(
        362e9, rel=1e-2)
    assert roofline.train_step_flops(base["model"], 32) == pytest.approx(
        9.31e12, rel=1e-2)
    # K5 + K6 at R = 10,240, V = 26,732, W = 128: 8RVW at 989 TFLOP/s
    fwd = roofline.loss_s(10240, 26732, 128, False)
    bwd = roofline.loss_s(10240, 26732, 128, True)
    assert fwd + bwd == pytest.approx(8 * 10240 * 26732 * 128 / 989e12,
                                      rel=1e-6)


def _imported(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax():
    for path in harness.BENCH.rglob("*.py"):
        assert not _imported(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        assert "bert4rec_tpu_torch" not in _imported(path), path
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.reference.check, benchmark.reference.judge;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True)
    loaded = set(ast.literal_eval(out.stdout.strip()))
    assert not loaded & {"bert4rec_tpu_torch", *harness.FORBIDDEN}


def test_a_whole_run_loads_no_jax_module():
    """A run in a fresh process, top-level names compared whole: the
    port's name begins with the JAX package's."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from benchmark.tests import tiny; from benchmark import harness;"
            "code, line, err = tiny.run_cell('ml20m_128.train');"
            "assert code == 0, err[-2000:];"
            "assert 'bert4rec_tpu_torch' in sys.modules;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "bert4rec_tpu_torch_fake", object())
    assert "bert4rec_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "bert4rec_tpu.x", object())
    assert "bert4rec_tpu" in harness.forbidden_modules()
