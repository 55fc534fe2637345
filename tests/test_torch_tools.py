"""The port's measurement tools (``bert4rec_tpu_torch/tools``: bench,
config_sweep, perf_guard, serving_bench, release_check) on the CPU, held
against the JAX tools they mirror: ``bench.make_batch``'s draws, a whole
smoke-size train step, the schema of ``bench --smoke``,
``build_overrides`` and the routing laws of all 13 shipped configs, a
two-config ``config_sweep --smoke``, perf_guard's variant table under its
renames and its verdict, ``serving_bench --smoke --device cpu`` and
release_check's stages with the stage runner stubbed."""

import ast
import importlib.util
import json
import pathlib
import types

import jax
import numpy as np
import pytest
import torch

from bert4rec_tpu.core.dtypes import DTypePolicy as JaxPolicy
from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models import BERT4RecModel as JaxModel
from bert4rec_tpu.ops import fused_encoder_layer as jax_fel
from bert4rec_tpu.ops import fused_mlm_loss as jax_fml
from bert4rec_tpu.trainers import BERT4RecTrainer as JaxTrainer
from bert4rec_tpu.trainers import optimizers as jax_opt
from bert4rec_tpu_torch.tools import (
    bench, config_sweep, perf_guard, release_check, serving_bench,
)
from bert4rec_tpu_torch.utils.checkpoint import flatten, params_from_numpy

REPO = pathlib.Path(__file__).resolve().parent.parent


def load_jax_tool(path: str, name: str):
    """A root script (``bench.py``, ``tools/config_sweep.py``) as a module
    under its own name; both import only the standard library at their
    top (``bench.build``, which switches JAX's PRNG for the process, is
    never called)."""
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bench():
    return load_jax_tool("bench.py", "jax_root_bench")


@pytest.fixture(scope="module")
def jax_sweep():
    return load_jax_tool("tools/config_sweep.py", "jax_tools_config_sweep")


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


class TestBench:

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    @pytest.mark.parametrize("smoke", [False, True], ids=["bench", "smoke"])
    def test_make_batch_equals_jax(self, jax_bench, monkeypatch, seed,
                                   smoke):
        dims = bench.SMOKE_DIMS if smoke else {}
        if smoke:
            for key, value in (("BATCH", dims["batch"]),
                               ("SEQ", dims["seq"]),
                               ("NPRED", dims["npred"]),
                               ("VOCAB", dims["vocab"])):
                monkeypatch.setattr(jax_bench, key, value)
        ref = jax_bench.make_batch(seed)
        got = bench.make_batch(seed, **dims)
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert got[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(got[key], ref[key])

    def test_shape_and_step_counts_are_jax(self, jax_bench):
        for key in ("BATCH", "SEQ", "NPRED", "VOCAB", "WARMUP_STEPS",
                    "MEASURE_STEPS_DEVICE", "MEASURE_STEPS_CPU",
                    "ANCHOR_ROUNDS", "ANCHOR_STEPS_PER_ROUND"):
            assert getattr(bench, key) == getattr(jax_bench, key), key

    def test_smoke_step_matches_jax(self, jax_bench):
        """``build`` at the smoke shape, dropout 0, bf16 (both packages'
        policy) against the model ``bench.build`` makes from the same
        kwargs in JAX (built here from ``BERT4RecConfig``: ``bench.build``
        would switch JAX's PRNG for the whole process), JAX's params
        carried across: two train steps (the first at the warm-up
        schedule's lr 0). Each loss agrees within 2e-4 relative: bf16
        rounds each product to 2^-8, and the two packages' CPU products
        round apart (measured 4.9e-5); the params after the AdamW steps
        within 1e-5 of their scale (the largest |param|: the second step's
        lr, 1e-6, moves each param by about that much, so a schedule or an
        update that differs from JAX's shows)."""
        over = dict(bench.SMOKE_MODEL, attention_dropout=0.0,
                    output_dropout=0.0)
        kwargs = dict(
            vocab_size=jax_bench.VOCAB, hidden_size=128, num_layers=2,
            num_attention_heads=4, inner_dim=512,
            max_sequence_length=jax_bench.SEQ, attention_dropout=0.2,
            output_dropout=0.5, max_predictions_per_seq=jax_bench.NPRED,
            use_fused_layer=False, use_fused_loss=False)
        kwargs.update(over)
        jt = JaxTrainer(JaxModel(config=JaxConfig(**kwargs),
                                 dtype_policy=JaxPolicy.bf16()))
        jt.initialize_model(optimizer=jax_opt.create_adam_w_optimizer(),
                            rng=jax.random.key(0))
        init = {k: np.asarray(v)
                for k, v in flatten(jt.state["params"]).items()}
        port = bench.build(over, device="cpu")
        assert port.model.config.to_dict() == {
            **port.model.config.to_dict(), **kwargs}
        assert port.model.dtype_policy.compute_dtype == torch.bfloat16
        port.initialize_model(
            optimizer=port.optimizer, params=params_from_numpy(init, "cpu"),
            device="cpu")
        for seed in (0, 1):
            batch = bench.make_batch(seed, **bench.SMOKE_DIMS)
            jt.state, jlogs = jt._train_step_fn(jt.state, batch)
            logs = port.train_step(port._put_batch(batch))
            ref = float(jlogs["loss"])
            assert abs(float(logs["loss"]) - ref) <= 2e-4 * abs(ref)
        jax_after = {k: np.asarray(v)
                     for k, v in flatten(jt.state["params"]).items()}
        after = {k: v.detach().numpy()
                 for k, v in flatten(port.state["params"]).items()}
        assert sorted(after) == sorted(jax_after)
        scale = max(float(np.abs(v).max()) for v in jax_after.values())
        moved = 0.0
        for k, ref in jax_after.items():
            assert float(np.abs(after[k] - ref).max()) <= 1e-5 * scale, k
            moved = max(moved, float(np.abs(after[k] - init[k]).max()))
        assert moved > 0

    def test_smoke_prints_jax_keys_and_metric(self, capsys):
        assert bench.main(["--smoke"]) == 0
        line = last_json(capsys.readouterr().out)
        assert sorted(line) == ["metric", "unit", "value", "vs_baseline"]
        assert line["metric"] == "smoke_train_examples_per_sec_cpu"
        assert '"smoke_train_examples_per_sec_cpu"' in \
            (REPO / "bench.py").read_text()
        assert line["unit"] == "examples/s" and line["value"] > 0

    def test_card_run_refuses_without_cuda(self, monkeypatch, capsys):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert bench.main([]) == 1
        assert "no CUDA device" in capsys.readouterr().err


class TestConfigSweep:

    @pytest.mark.parametrize("name", config_sweep.config_names())
    def test_overrides_and_routes_equal_jax(self, jax_sweep, name):
        cfg = config_sweep.load(name)
        assert cfg == json.loads((jax_sweep.CONFIG_DIR / f"{name}.json")
                                 .read_text())
        assert config_sweep.DATASET_DIMS == jax_sweep.DATASET_DIMS
        overrides, dims = config_sweep.build_overrides(name, cfg)
        assert (overrides, dims) == jax_sweep.build_overrides(name, cfg)
        law = config_sweep.routes(overrides)
        jcfg = JaxConfig(**overrides)
        fused = jax_fel.fused_layer_supported(
            batch=jax_sweep.BATCH, seq_len=dims[1],
            hidden=jcfg.hidden_size, inner_dim=jcfg.inner_dim,
            num_heads=jcfg.num_attention_heads, dtype_bytes=2,
            temporal=False)
        assert (law["layer_kernel"] != "unfused") == fused
        assert law["layer_kernel"] in ("wgmma", "unfused")
        whole = jax_fml.fused_loss_supported(jcfg.padded_vocab_size,
                                             jcfg.table_width)
        assert law["loss_kernel"] == ("whole_table" if whole
                                      else "vocab_tiled")
        rows = jax_sweep.BATCH * dims[2]
        padded = rows + (-rows) % jax_fml.BWD_ROW_TILE
        merged = padded * jcfg.table_width * 4 <= jax_fml._MERGED_DH_BYTES
        assert law["loss_backward"] == (
            "K4" if whole else ("K6" if merged else "K7"))
        expected = {"steam_256": "K6", "beauty_256": "K7",
                    "ml-20m_256": "K7", "ml-1m_64": "K4"}
        if name in expected:
            assert law["loss_backward"] == expected[name]

    def test_smoke_of_two_configs(self, capsys, tmp_path):
        out = tmp_path / "sweep.json"
        assert config_sweep.main(["--smoke", "--configs",
                                  "ml-1m_64,steam_256",
                                  "--json-out", str(out)]) == 0
        report = last_json(capsys.readouterr().out)
        assert report == json.loads(out.read_text())
        assert sorted(report["configs"]) == ["ml-1m_64", "steam_256"]
        for row in report["configs"].values():
            assert row["batch"] == config_sweep.SMOKE_BATCH
            assert row["ms_per_step"] > 0 and row["examples_per_sec"] > 0
            # the CPU trains through the plain path, and counts nothing
            assert row["layer_kernel"] == "unfused"
            assert set(row["launches"].values()) == {0}
        assert report["configs"]["steam_256"]["loss_backward"] == "K6"
        assert report["device"] == "cpu"

    def test_unknown_config_is_refused(self):
        with pytest.raises(SystemExit):
            config_sweep.main(["--smoke", "--configs", "ml-2m_64"])


def jax_perf_guard_tables():
    """The variant table, VARIANT_DIMS and VARIANT_STEPS of
    ``tools/perf_guard.py``'s worker, evaluated from its source with
    ``bench.build`` and ``build_trainer`` recording their arguments."""
    tree = ast.parse((REPO / "tools" / "perf_guard.py").read_text())
    jax_bench = load_jax_tool("bench.py", "jax_root_bench_for_guard")
    ns = {
        "bench": types.SimpleNamespace(
            build=lambda o, steps_per_call=1: (o, steps_per_call),
            SEQ=jax_bench.SEQ, NPRED=jax_bench.NPRED,
            VOCAB=jax_bench.VOCAB),
        "build_trainer": lambda layer, loss, steps_per_call=1: (
            dict(use_fused_layer=layer, use_fused_loss=loss),
            steps_per_call),
        "BATCH": jax_bench.BATCH, "dict": dict,
    }
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in ("variants", "VARIANT_DIMS",
                                           "VARIANT_STEPS"):
            found[node.targets[0].id] = eval(compile(
                ast.Expression(node.value), "perf_guard", "eval"), ns)
    return found


class TestPerfGuard:

    def test_variants_are_jax_under_the_renames(self):
        jax_tables = jax_perf_guard_tables()
        jax_name = {v: k for k, v in perf_guard.RENAMED.items()}
        assert perf_guard.RENAMED == {"xla": "unfused",
                                      "xla_multi4": "unfused_multi4"}
        port = {perf_guard.RENAMED.get(k, k): v
                for k, v in jax_tables["variants"].items()}
        assert list(port) == list(perf_guard.VARIANTS)
        assert len(port) == 10
        for name, (overrides, steps) in perf_guard.VARIANTS.items():
            assert (overrides, steps) == port[name], jax_name.get(name, name)
        assert perf_guard.VARIANT_DIMS == jax_tables["VARIANT_DIMS"]
        assert perf_guard.VARIANT_STEPS == jax_tables["VARIANT_STEPS"]
        assert set(perf_guard.BUDGET_MS) <= set(perf_guard.VARIANTS)

    @staticmethod
    def report(**ms):
        base = {name: 1.0 for name in perf_guard.VARIANTS}
        base.update(ms)
        return {"ms_per_step": base, "fused_speedup_vs_unfused": 2.0}

    def test_verdict_names_each_miss(self):
        assert perf_guard.verdict(self.report(), min_speedup=1.0) == []
        over = perf_guard.BUDGET_MS["fused_full"] + 1
        fails = perf_guard.verdict(self.report(fused_full=over),
                                   min_speedup=1.0)
        assert len(fails) == 1 and fails[0].startswith("fused_full:")
        slow = dict(self.report(), fused_speedup_vs_unfused=0.5)
        assert perf_guard.verdict(slow, min_speedup=1.0) == [
            "fused speedup 0.50x < 1.0x"]

    @pytest.mark.parametrize("miss", [False, True], ids=["pass", "miss"])
    def test_main_exits_1_on_a_miss(self, monkeypatch, capsys, miss):
        over = perf_guard.BUDGET_MS["reddit_tiled"] + 1 if miss else 1.0
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda *a: "stub")
        monkeypatch.setattr(perf_guard, "measure", lambda rounds: dict(
            self.report(reddit_tiled=over),
            fused_speedup_vs_unfused=100.0))
        assert perf_guard.main([]) == (1 if miss else 0)
        captured = capsys.readouterr()
        assert last_json(captured.out)["failures"] == (
            [f"reddit_tiled: {over:.2f} ms > budget "
             f"{perf_guard.BUDGET_MS['reddit_tiled']} ms"] if miss else [])
        assert ("REGRESSION: reddit_tiled" in captured.err) == miss

    def test_smoke_times_every_variant_on_the_cpu(self, capsys):
        assert perf_guard.main(["--smoke"]) == 0
        report = last_json(capsys.readouterr().out)
        assert sorted(report["ms_per_step"]) == sorted(perf_guard.VARIANTS)
        assert report["smoke_verdict"] == {"pass_at_twice": True,
                                           "misses_at_half": 10}


class TestServingBench:

    def test_smoke_on_the_cpu_answers_every_request(self, capsys):
        assert serving_bench.main(["--smoke", "--device", "cpu"]) == 0
        line = last_json(capsys.readouterr().out)
        for key in ("histories_per_sec", "p50_ms", "p99_ms", "batches",
                    "mean_batch_fill"):
            assert key in line
        assert line["requests"] == serving_bench.SMOKE_LOAD["requests"]
        assert 0 < line["p50_ms"] <= line["p99_ms"]
        assert line["batches"] >= 1 and line["mean_batch_fill"] >= 1
        assert line["platform"] == "cpu"

    def test_card_default_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            serving_bench.run(clients=1, requests=1)


class TestReleaseCheck:

    def test_stage_order(self):
        names = [n for n, _, _ in release_check.stages()]
        assert names == [
            "cpu-suite", "bench-smoke", "quality-smoke-bert4rec",
            "quality-smoke-sasrec", "chip-smoke", "card-tests",
            "perf-guard", "quality-ml1m-scale", "quality-ml20m-scale"]
        fast = [n for n, _, _ in release_check.stages(fast=True,
                                                      cpu_only=True)]
        assert fast == names[1:4]
        plan = {n: cmd for n, cmd, _ in release_check.stages()}
        files = [a for a in plan["cpu-suite"] if a.endswith(".py")]
        assert all(pathlib.PurePath(a).name.startswith("test_torch_")
                   for a in files) and len(files) > 25
        assert plan["perf-guard"][-2:] == [
            "bert4rec_tpu_torch.tools.perf_guard", "--numerics"]
        assert plan["chip-smoke"][-1] == "chip_smoke.py"
        assert "--noconftest" in plan["card-tests"]
        assert all("jax" not in " ".join(cmd) for cmd in plan.values())

    @pytest.mark.parametrize("failing", [None, "card-tests"])
    def test_pass_and_fail(self, capsys, failing):
        ran = []

        def runner(name, cmd, timeout):
            ran.append(name)
            return name != failing, 1.5

        rc = release_check.main([], runner=runner)
        line = last_json(capsys.readouterr().out)
        assert ran == [n for n, _, _ in release_check.stages()]
        assert rc == (1 if failing else 0)
        assert line["release_check"] == ("FAIL" if failing else "PASS")
        assert line["stages"]["bench-smoke"] == {"ok": True, "seconds": 1.5}
        if failing:
            assert line["stages"][failing]["ok"] is False
