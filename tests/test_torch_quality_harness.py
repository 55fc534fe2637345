"""The port's quality harness held against the JAX package's on the CPU:
the presets and gate tables equal to JAX's dicts, the argument parser's
defaults and choices, the tiny smoke learning and beating the popularity
floor (both families), ``run_oracle`` and ``run_oracle_temporal`` end to
end at a cut tiny preset emitting JAX's schema and checks, ``--int8``'s
``results_int8`` block (JAX's keys and check; its drop equal to JAX's on
the same params), ``run_real`` exiting 2 without data, and every mode's
default output directory under the port's own prefix."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bert4rec_tpu.evaluation import quality_harness as jax_qh
from bert4rec_tpu_torch.evaluation import quality_harness as qh

REPO = pathlib.Path(__file__).resolve().parent.parent

# the result keys of JAX's run_oracle (quality_harness.py:1197) and
# run_oracle_temporal (:706) without --gap-curve, --full-ranking and
# --int8, and of its run_smoke (:349)
ORACLE_KEYS = {"dataset", "platform", "generator", "wall_seconds", "results",
               "results_bayes_oracle", "results_popularity_floor",
               "results_broken_off_by_one",
               "results_broken_shuffled_negatives", "oracle_gap", "gates",
               "checks"}
TEMPORAL_KEYS = {"dataset", "platform", "generator", "wall_seconds",
                 "results", "results_temporal_bayes_ceiling",
                 "results_time_blind_bayes_ceiling",
                 "results_time_blind_ablation", "results_popularity_floor",
                 "results_broken_off_by_one",
                 "results_broken_shuffled_negatives", "oracle_gap", "gates",
                 "checks"}
SMOKE_KEYS = {"dataset", "encoder_config", "platform", "hyperparameters",
              "vocab_size", "wall_seconds", "results",
              "results_popularity_floor"}
METRICS = {"Valid Ranks", "NDCG@1", "NDCG@5", "NDCG@10", "HR@1", "HR@5",
           "HR@10", "MAP"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tiny models gain nothing from more, and
    the suite's parallel workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cut_tiny(monkeypatch):
    """The tiny oracle preset at one epoch over fewer rows."""
    presets = {k: dict(v) for k, v in qh._ORACLE_PRESETS.items()}
    presets["tiny"].update(epochs=1, train_rows=256, test_rows=128)
    monkeypatch.setattr(qh, "_ORACLE_PRESETS", presets)


@pytest.fixture
def emitted(monkeypatch, tmp_path):
    """Every ``emit`` redirected under ``tmp_path``; records the output
    directory each mode asked for and its payload."""
    calls = []
    emit = qh.emit

    def record(out_dir, payload):
        calls.append((str(out_dir), payload))
        return emit(tmp_path / str(len(calls)), payload)

    monkeypatch.setattr(qh, "emit", record)
    return calls


class TestTables:

    @pytest.mark.parametrize("name", [
        "_SMOKE_PRESETS", "_ORACLE_PRESETS", "_TEMPORAL_ORACLE_GATES",
        "_SASREC_ORACLE_PRESET_OVERRIDES", "_SASREC_ORACLE_GATE_OVERRIDES"])
    def test_equal_to_jax(self, name):
        assert getattr(qh, name) == getattr(jax_qh, name)

    def test_argparser_follows_jax(self):
        ours = {a.dest: a for a in qh.build_argparser()._actions}
        theirs = {a.dest: a for a in jax_qh.build_argparser()._actions}
        assert set(ours) == set(theirs) | {"device"}
        for dest, a in theirs.items():
            b = ours[dest]
            assert (b.option_strings, b.default, b.choices, b.type,
                    b.nargs, b.const) == (a.option_strings, a.default,
                                          a.choices, a.type, a.nargs,
                                          a.const), dest
        assert ours["device"].default == "cuda"
        args = qh.build_argparser().parse_args([])
        assert (args.dataset, args.config, args.batch_size, args.dup,
                args.finetuning_split, args.epochs) == (
            "ml_1m", "ml-1m_128", 256, None, 0.1, 150)
        with pytest.raises(SystemExit):
            qh.build_argparser().parse_args(["--smoke-family", "nope"])


class TestModes:

    @pytest.mark.parametrize("family", ["bert4rec", "sasrec"])
    def test_smoke_learns_and_beats_the_floor(self, family, emitted):
        rc = qh.main(["--smoke", "--smoke-family", family, "--device",
                      "cpu"])
        assert rc == 0
        (out, payload), = emitted
        assert out == qh.OUT_PREFIX + ("/smoke_sasrec" if family == "sasrec"
                                       else "/smoke")
        assert set(payload) == SMOKE_KEYS
        assert payload["results"]["HR@10"] > 0.5
        assert payload["results"]["HR@10"] > \
            payload["results_popularity_floor"]["HR@10"]
        assert payload["platform"] == "cpu"

    @pytest.mark.parametrize("family", ["bert4rec", "sasrec"])
    def test_run_oracle_end_to_end(self, family, cut_tiny, emitted):
        rc = qh.main(["--oracle", "--oracle-family", family, "--device",
                      "cpu"])
        (out, payload), = emitted
        assert rc in (0, 1) and rc == (0 if all(payload["checks"].values())
                                       else 1)
        sasrec = family == "sasrec"
        broken = ("results_broken_noncausal" if sasrec
                  else "results_broken_masking_rate")
        assert out == qh.OUT_PREFIX + ("/oracle_tiny_sasrec" if sasrec
                                       else "/oracle_tiny")
        assert set(payload) == ORACLE_KEYS | {broken}
        assert set(payload["checks"]) == {
            "oracle_non_saturated", "oracle_clears_floor",
            "model_reaches_85pct_of_oracle_hr10",
            "model_does_not_beat_bayes", "off_by_one_collapses",
            "shuffled_negatives_inflate",
            "noncausal_leak_collapses" if sasrec
            else "wrong_masking_rate_degrades",
            "model_reaches_80pct_of_oracle_ndcg10"}
        for key in ("results", "results_bayes_oracle", broken):
            assert set(payload[key]) == METRICS
            assert payload[key]["Valid Ranks"] == 128
        assert set(payload["oracle_gap"]) == {"HR@10_ratio",
                                              "NDCG@10_ratio"}
        assert payload["gates"] == {"hr10": 0.85, "ndcg10": 0.80}
        # the planted world's ceiling and broken variants need no training
        bayes = payload["results_bayes_oracle"]["HR@10"]
        assert 0.5 <= bayes <= 0.95
        assert payload["checks"]["off_by_one_collapses"]
        assert payload["checks"]["shuffled_negatives_inflate"]

    def test_run_oracle_full_ranking_and_gap_curve(self, cut_tiny, emitted):
        qh.main(["--oracle", "--gap-curve", "1,2", "--full-ranking",
                 "--device", "cpu"])
        (_, payload), = emitted
        assert [c["epochs"] for c in payload["gap_curve"]] == [1, 2]
        full = payload["results_full_ranking"]
        assert set(full) == {"results", "ms_per_batch", "batch_size",
                             "results_bayes_oracle", "oracle_gap"}
        assert {"full_ranking_does_not_beat_bayes"} <= set(payload["checks"])
        assert full["results"]["HR@10"] <= \
            full["results_bayes_oracle"]["HR@10"] + 0.05

    def test_run_oracle_temporal_end_to_end(self, cut_tiny, emitted):
        rc = qh.main(["--oracle", "--oracle-family", "temporal",
                      "--oracle-epochs", "1", "--full-ranking", "--device",
                      "cpu"])
        (out, payload), = emitted
        assert rc == (0 if all(payload["checks"].values()) else 1)
        assert out == qh.OUT_PREFIX + "/oracle_tiny_temporal"
        assert set(payload) == TEMPORAL_KEYS | {"results_full_ranking"}
        assert set(payload["checks"]) == {
            "oracle_non_saturated", "oracle_clears_floor",
            "time_signal_exists", "model_reaches_90pct_of_oracle_ndcg10",
            "model_reaches_85pct_of_oracle_hr1",
            "model_uses_time_vs_ablation",
            "ablation_bounded_by_blind_ceiling",
            "model_does_not_beat_bayes", "off_by_one_collapses",
            "shuffled_negatives_inflate",
            "full_ranking_does_not_beat_bayes"}
        assert payload["generator"]["epochs"] == 1
        assert payload["generator"]["gaps_s"] == [3_600, 43_200]
        assert set(payload["results_full_ranking"]) == {
            "results", "ms_per_batch", "batch_size",
            "results_temporal_bayes_ceiling",
            "results_time_blind_bayes_ceiling", "oracle_gap"}
        # the planted world's ceilings need no training
        for check in ("time_signal_exists", "off_by_one_collapses",
                      "shuffled_negatives_inflate"):
            assert payload["checks"][check], check

    def test_temporal_gap_curve_refused(self, cut_tiny):
        with pytest.raises(SystemExit, match="gap-curve"):
            qh.main(["--oracle", "--oracle-family", "temporal",
                     "--gap-curve", "1,2", "--device", "cpu"])


class TestRefusalsAndDefaults:

    @pytest.mark.parametrize("argv", [
        ["--oracle"], ["--oracle", "--oracle-family", "temporal"],
        ["--smoke"]])
    def test_int8_raises_before_training(self, argv, monkeypatch):
        """``--int8`` used to raise before any training; with
        models/quantization.py ported, no mode raises on it: each reaches
        ``train()`` (stopped there by a sentinel), the smoke mode ignoring
        the flag as JAX's does."""
        from bert4rec_tpu_torch.trainers import BERT4RecTrainer

        class Reached(Exception):
            pass

        def reached(*a, **k):
            raise Reached

        monkeypatch.setattr(BERT4RecTrainer, "train", reached)
        with pytest.raises(Reached):
            qh.main(argv + ["--int8", "--device", "cpu"])
        assert qh.build_argparser().parse_args(["--oracle", "--int8"]).int8

    def test_real_mode_exits_without_data(self, tmp_path, capsys):
        rc = qh.main(["--dataset", "ml_1m", "--out", str(tmp_path),
                      "--device", "cpu"])
        if rc == 0:  # the corpus is on disk: the run produced results
            assert (tmp_path / "eval_results.json").exists()
            return
        assert rc == 2
        assert "not on disk" in capsys.readouterr().out

    def test_default_outputs_lie_outside_jax_artifacts(self):
        """The port writes under quality_runs/torch/, a directory none of
        the JAX package's modes writes (their defaults are
        quality_runs/<mode>, and no mode is named "torch")."""
        assert qh.OUT_PREFIX == "quality_runs/torch"
        jax_dirs = {p.name for p in (REPO / "quality_runs").iterdir()
                    if (p / "eval_results.json").exists()}
        assert "torch" not in jax_dirs
        src = (REPO / "bert4rec_tpu_torch/evaluation/"
               "quality_harness.py").read_text()
        # no string literal names another directory of quality_runs/
        assert src.count('"quality_runs/') == 1
        assert 'OUT_PREFIX = "quality_runs/torch"' in src

    def test_cli_runs_as_a_module(self):
        """``python -m ...tools.quality_run`` parses JAX's flags and
        dispatches (here to the temporal family's ``--gap-curve``
        refusal, before any work)."""
        out = subprocess.run(
            [sys.executable, "-m", "bert4rec_tpu_torch.tools.quality_run",
             "--oracle", "--oracle-family", "temporal", "--int8",
             "--gap-curve", "1,2", "--device", "cpu"],
            capture_output=True, text=True, timeout=120, cwd=REPO)
        assert out.returncode != 0 and "gap-curve" in out.stderr


class TestInt8Block:
    """``--int8``'s ``results_int8`` (JAX quality_harness.py:647-664,
    :1120-1142) and its gate (:701-705, :1172-1181)."""

    @pytest.mark.parametrize("family", ["bert4rec", "temporal"])
    def test_block_has_jax_schema_and_check(self, family, cut_tiny,
                                            emitted):
        argv = ["--oracle", "--oracle-family", family, "--int8", "--device",
                "cpu"]
        rc = qh.main(argv + (["--oracle-epochs", "1"]
                             if family == "temporal" else []))
        (_, payload), = emitted
        block = payload["results_int8"]
        keys = {"results", "table_bytes_fp32", "table_bytes_int8",
                "ndcg10_drop_vs_fp32", "gate_ndcg10_drop"}
        assert set(block) == (keys | {"hr10_drop_vs_fp32"}
                              if family == "bert4rec" else keys)
        assert set(block["results"]) == METRICS
        ps = qh._ORACLE_PRESETS["tiny"]
        vocab, width = ps["n_items"] + 3, ps["model"]["hidden_size"]
        assert (block["table_bytes_fp32"], block["table_bytes_int8"]) == \
            (vocab * width * 4, vocab * width + vocab * 4)
        assert block["gate_ndcg10_drop"] == 0.01
        assert payload["checks"]["int8_ndcg10_drop_within_0.01"] == (
            block["ndcg10_drop_vs_fp32"] <= 0.01)
        assert block["ndcg10_drop_vs_fp32"] == round(
            payload["results"]["NDCG@10"] - block["results"]["NDCG@10"], 4)
        assert rc == (0 if all(payload["checks"].values()) else 1)

    def test_drop_equals_jax_on_the_same_params(self, monkeypatch):
        """The block's numbers from the port's harness equal JAX's
        computation on the same params and test split (host negatives in
        both packages): the drops within 1e-4, the bytes exactly."""
        import functools

        import jax

        from bert4rec_tpu.evaluation import markov_oracle as jax_mo
        from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
        from bert4rec_tpu.models import BERT4RecModel as JaxModel
        from bert4rec_tpu.models import quantization as jax_q
        from bert4rec_tpu_torch import evaluation
        from bert4rec_tpu_torch.evaluation import markov_oracle as mo
        from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
        from bert4rec_tpu_torch.utils import checkpoint
        from tests.test_torch_oracles import PRED, SEQ, TINY, loo_datasets
        import bert4rec_tpu.evaluation as jax_evaluation

        for pkg in (evaluation, jax_evaluation):
            monkeypatch.setattr(pkg, "BERT4RecEvaluator", functools.partial(
                pkg.BERT4RecEvaluator, device_negatives=False))
        cat = mo.MarkovCatalog(n_items=TINY, seed=5)
        train = cat.sample_sequences(300, 12, SEQ, seed=60)
        source = [int(t) for q in train for t in q]
        ds, jds = loo_datasets(cat.sample_sequences(200, 12, SEQ, seed=61))
        kw = dict(vocab_size=cat.vocab_size, hidden_size=32, num_layers=2,
                  num_attention_heads=4, inner_dim=64,
                  max_sequence_length=SEQ, max_predictions_per_seq=PRED)
        jmodel = JaxModel(config=JaxConfig(**kw))
        jparams = jmodel.init(jax.random.key(8))
        jparams["mlm"]["output_bias"] = np.random.default_rng(8).normal(
            size=jparams["mlm"]["output_bias"].shape).astype(np.float32)
        model = BERT4RecModel(config=BERT4RecConfig(**kw))
        params = checkpoint.params_from_numpy(
            {k: np.asarray(v) for k, v in checkpoint.flatten(
                jax.tree_util.tree_map(np.asarray, jparams)).items()}, "cpu")
        ekw = dict(source=source, sample_size=100, seed=0, batch_size=64)
        res = mo.evaluate_scorer(model, params, ds, **ekw)
        block = qh.int8_block(model, params, ds, ekw, res, "test")
        jres = jax_mo.evaluate_scorer(jmodel, jparams, jds, **ekw)
        jqp = jax_q.quantize_params(jparams)
        jq = jax_mo.evaluate_scorer(jmodel, jqp, jds, **ekw)
        for metric, key in (("NDCG@10", "ndcg10_drop_vs_fp32"),
                            ("HR@10", "hr10_drop_vs_fp32")):
            want = round(float(jres[metric]) - float(jq[metric]), 4)
            assert abs(block[key] - want) <= 1e-4, (key, block[key], want)
        assert block["table_bytes_fp32"] == jax_q.table_bytes(jparams)
        assert block["table_bytes_int8"] == jax_q.table_bytes(jqp)


def test_emit_schema(tmp_path):
    path = qh.emit(tmp_path, {"dataset": "x",
                              "results": {"HR@10": 0.5, "NDCG@10": 0.4}})
    assert json.loads(path.read_text())["results"]["HR@10"] == 0.5
    assert np.isclose(json.loads(path.read_text())["results"]["NDCG@10"],
                      0.4)


class TestTools:
    """The card's measurement scripts around the harness, run on the CPU
    at the cut tiny preset: they drive the same paths and print their
    JSON lines (the CPU counts no kernel launch)."""

    def test_count_launches_wraps_the_harness(self, cut_tiny, tmp_path,
                                              capsys):
        from bert4rec_tpu_torch.tools import count_launches
        rc = count_launches.main(["--oracle", "--device", "cpu", "--out",
                                  str(tmp_path)])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["rc"] == rc
        assert (tmp_path / "eval_results.json").exists()
        assert set(line["launches"]) == {
            f"{fn}.{attr}" for fn, attrs in count_launches.COUNTERS.items()
            for attr in attrs}
        assert not any(line["launches"].values())

    def test_oracle_drift_compares_three_pairs(self, monkeypatch, capsys):
        from bert4rec_tpu_torch.tools import oracle_drift
        monkeypatch.setattr(sys, "argv", ["oracle_drift", "--scale", "tiny",
                                          "--steps", "3", "--device", "cpu"])
        assert oracle_drift.main() == 0
        rows = [json.loads(x) for x in
                capsys.readouterr().out.strip().splitlines()]
        assert [r["step"] for r in rows] == [1, 3]
        for row in rows:
            assert set(row) == {"step", "seconds", "kernels_vs_plain",
                                "plain_vs_plain_one_ulp",
                                "kernels_vs_kernels"}
        # one ulp apart in every parameter from the start
        assert rows[0]["plain_vs_plain_one_ulp"]["median_param_rel"] > 0
