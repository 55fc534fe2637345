"""Quality harness (port of ``bert4rec_tpu/evaluation/quality_harness.py``):
the presets, gate tables, training loops and result files of the smoke,
real-data and Bayes-oracle quality measurements. The oracle scorers live
in ``markov_oracle.py`` and ``temporal_oracle.py``; the CLI is

    python -m bert4rec_tpu_torch.tools.quality_run --oracle --oracle-scale ml1m

Every mode runs on the card by default (the fused layer and loss, fp32,
4 steps a call); ``device="cpu"`` (``--device cpu``) runs the plain
versions. Results go under ``quality_runs/torch/`` unless ``--out`` says
otherwise, apart from the JAX package's artifacts.

The reference's hyperparameters (reference trainers/optimizers.py and
bert4rec_ml_1m_example.py:14-95): AdamW lr 1e-4, 400k-step polynomial
decay, 100 warmup steps, weight decay 0.01, global-norm clip 5.0, batch
256, input duplication 10, finetuning split 0.1, early stopping on
val_loss.
"""

import argparse
import json
import pathlib
import sys
import time

# every mode's default output directory lies under this prefix, apart
# from the JAX package's artifacts in quality_runs/<mode>
OUT_PREFIX = "quality_runs/torch"


def build_argparser():
    """JAX's flags, defaults and choices, and ``--device``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", default="ml_1m",
                   choices=["ml_1m", "ml_20m", "beauty", "steam", "reddit"])
    p.add_argument("--config", default="ml-1m_128",
                   help="encoder config name (config/bert4rec_train_configs)")
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--dup", type=int, default=None,
                   help="input duplication factor; default = the "
                        "dataset's own reference default (ML-1M 10, "
                        "ML-20M 5, Beauty 5, Steam 3, Reddit 2)")
    p.add_argument("--finetuning-split", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default=None,
                   help=f"output dir (default: {OUT_PREFIX}/<mode>)")
    p.add_argument("--smoke", action="store_true",
                   help="offline end-to-end self-test on synthetic data")
    p.add_argument("--smoke-scale", default="tiny",
                   choices=["tiny", "ml1m", "ml20m", "reddit"],
                   help="--smoke size: 'tiny' (CPU, seconds), or the "
                        "catalog scales run on the card: 'ml1m' (3706 "
                        "items), 'ml20m' (26.7k, vocab-tiled loss) or "
                        "'reddit' (335k items)")
    p.add_argument("--smoke-family", default="bert4rec",
                   choices=["bert4rec", "sasrec", "temporal"],
                   help="--smoke model family: masked-LM BERT4Rec, causal "
                        "next-item SASRec, or the temporal family's "
                        "copy-by-time-delta gate against a time-blind "
                        "ablation (its own world; --smoke-scale is ignored)")
    p.add_argument("--resume", action="store_true",
                   help="resume from a checkpoint in the output dir. Off "
                        "by default: a quality measurement starts from "
                        "fresh weights")
    p.add_argument("--oracle", action="store_true",
                   help="the quality benchmark that cannot saturate: "
                        "planted Markov-mixture structure with a computable "
                        "Bayes oracle (evaluation/markov_oracle.py); "
                        "reports the model/oracle gap and deliberately "
                        "broken variants that must measurably fail")
    p.add_argument("--oracle-scale", default="tiny",
                   choices=["tiny", "ml1m", "ml20m", "reddit"],
                   help="--oracle size: 'tiny' (CPU), 'ml1m' (3706-item "
                        "catalog, seq 200, the ml-1m_128 encoder shape), "
                        "'ml20m' (26.7k items: the vocab-tiled loss) or "
                        "'reddit' (335k items); the last three on the card")
    p.add_argument("--oracle-epochs", type=int, default=None,
                   help="override the preset's training epoch budget")
    p.add_argument("--gap-curve", default=None,
                   help="comma-separated epoch budgets (e.g. '10,20,40,80')"
                        ": train a fresh model per budget against the one "
                        "oracle and record the model/oracle gap at each; "
                        "the largest budget's model is the gated one")
    p.add_argument("--oracle-family", default="bert4rec",
                   choices=["bert4rec", "sasrec", "temporal"],
                   help="--oracle model family: 'sasrec' gates the causal "
                        "next-item family on the same planted structure "
                        "(its train-side broken variant is a missing causal "
                        "mask); 'temporal' plants a time-routed law with "
                        "two ceilings, temporal and time-blind "
                        "(evaluation/temporal_oracle.py)")
    p.add_argument("--full-ranking", action="store_true",
                   help="also evaluate against the whole catalog (the "
                        "unbiased protocol; Krichene & Rendle 2020) under "
                        "results_full_ranking")
    p.add_argument("--int8", action="store_true",
                   help="additionally quantize the trained model's "
                        "embedding table to int8 (models/quantization.py, "
                        "the serving fast path) and re-run the sampled "
                        "eval — emits results_int8 with the measured "
                        "fp32->int8 metric delta and gates it "
                        "(int8_ndcg10_drop gate when the preset defines "
                        "one; a sanity bound otherwise)")
    p.add_argument("--device", default="cuda",
                   help="where to train and evaluate (default: the card; "
                        "'cpu' runs the kernels' plain versions)")
    return p


def emit(out_dir, payload):
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "eval_results.json"
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps({"HR@10": payload["results"].get("HR@10"),
                      "NDCG@10": payload["results"].get("NDCG@10"),
                      "out": str(path)}))
    return path


def platform_name(device) -> str:
    """``"gpu <card name>"`` on the card, else the device type."""
    import torch
    if device.type == "cuda":
        return "gpu " + torch.cuda.get_device_name(device)
    return device.type


def int8_block(model, params, test, ekw, res_model, tag, hr=True) -> dict:
    """JAX's ``results_int8``: the trained model's table quantized to int8
    weights-only (models/quantization.py) and the sampled evaluation run
    again through the quantized candidate-scoring path (the raw codes,
    scales after the contraction: the real quantized serving quality);
    the table's bytes both ways and the NDCG@10 (and, for the Markov
    oracle, HR@10) drop against fp32."""
    from bert4rec_tpu_torch.evaluation.markov_oracle import evaluate_scorer
    from bert4rec_tpu_torch.models import quantization
    qparams = quantization.quantize_params(params)
    res_q = evaluate_scorer(model, qparams, test, **ekw)
    print(f"[{tag}] int8-quantized model: {_r4(res_q)}", flush=True)
    block = {
        "results": _floats(res_q),
        "table_bytes_fp32": quantization.table_bytes(params),
        "table_bytes_int8": quantization.table_bytes(qparams),
        "ndcg10_drop_vs_fp32": round(
            float(res_model["NDCG@10"]) - float(res_q["NDCG@10"]), 4),
    }
    if hr:
        block["hr10_drop_vs_fp32"] = round(
            float(res_model["HR@10"]) - float(res_q["HR@10"]), 4)
    return block


def gate_int8(checks: dict, block: dict, gates: dict) -> None:
    """The quantized serving path must hold quality: JAX's check of the
    NDCG@10 drop at the preset's ``int8_ndcg10_drop`` (0.01 by default;
    per-row symmetric int8 on a 128-wide table is a ~0.4% weight
    perturbation, so a visible drop means a broken scale path)."""
    drop_gate = gates.get("int8_ndcg10_drop", 0.01)
    checks[f"int8_ndcg10_drop_within_{drop_gate}"] = (
        block["ndcg10_drop_vs_fp32"] <= drop_gate)
    block["gate_ndcg10_drop"] = drop_gate


def _floats(d: dict) -> dict:
    return {k: float(v) for k, v in d.items()}


def _r4(d, keys=("HR@1", "HR@5", "HR@10", "NDCG@10", "MAP")):
    return {k: round(float(d[k]), 4) for k in keys if k in d}


def run_real(args, *, device="cuda"):
    """The reference's headline configuration on a real corpus, with the
    reference's hyperparameters. Returns 2 when the corpus is not on disk
    (nothing is downloaded)."""
    from bert4rec_tpu_torch import config as config_pkg
    from bert4rec_tpu_torch import trainers
    from bert4rec_tpu_torch.core.device import resolve_device
    from bert4rec_tpu_torch.dataloaders import get_dataloader_factory
    from bert4rec_tpu_torch.evaluation import (
        BERT4RecEvaluator, PopularityScorer,
    )
    from bert4rec_tpu_torch.models import BERT4RecModel
    from bert4rec_tpu_torch.trainers import optimizers
    from bert4rec_tpu_torch.trainers.callbacks import EarlyStopping

    factory = get_dataloader_factory("bert4rec")
    dl_kwargs = ({} if args.dup is None
                 else {"input_duplication_factor": args.dup})
    dataloader = getattr(factory, f"create_{args.dataset}_dataloader")(
        **dl_kwargs)
    if not dataloader.data_source.is_available():
        print(json.dumps({
            "error": f"dataset {args.dataset} not on disk and this "
                     f"environment has no network; place the raw files "
                     f"under the data dir and rerun"}))
        return 2

    device = resolve_device(device)
    on_card = device.type == "cuda"
    train_ds, val_ds, test_ds = dataloader.prepare_training(
        finetuning_split=args.finetuning_split)
    tokenizer = dataloader.get_tokenizer()
    vocab = tokenizer.get_vocab_size()
    config = config_pkg.load_train_config(
        args.config, vocab_size=vocab, use_fused_layer=on_card,
        use_fused_loss=on_card)
    model = BERT4RecModel(config=config)
    trainer = trainers.get("bert4rec", model=model,
                           steps_per_call=4 if on_card else 1)
    # the reference's optimizer settings
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=1e-4, num_train_steps=400_000, num_warmup_steps=100),
        seed=args.seed, device=device)
    trainer.append_callback(EarlyStopping(monitor="val_loss", patience=20))

    out_dir = pathlib.Path(args.out or f"{OUT_PREFIX}/{args.dataset}")
    ckpt = out_dir / "checkpoints" / "best.npz"
    if not args.resume and ckpt.exists():
        # a fresh run: a leftover checkpoint would auto-resume and report
        # old weights as a new run
        ckpt.unlink()
    t0 = time.time()
    history = trainer.train(train_ds, val_ds, checkpoint_path=ckpt,
                            epochs=args.epochs, batch_size=args.batch_size,
                            seed=args.seed)

    results = BERT4RecEvaluator(dataloader=dataloader).evaluate(
        model, trainer.params, test_ds, batch_size=args.batch_size)
    # the popularity floor under the same protocol
    source = list(dataloader.create_item_list_tokenized())
    floor = BERT4RecEvaluator(dataloader=dataloader).evaluate(
        PopularityScorer.from_source(source, vocab, device=device),
        None, test_ds, batch_size=args.batch_size)
    full_results = None
    if args.full_ranking:
        full_results = BERT4RecEvaluator(full_ranking=True).evaluate(
            model, trainer.params, test_ds, batch_size=args.batch_size)
    emit(out_dir, {
        "dataset": args.dataset,
        "encoder_config": args.config,
        "platform": platform_name(device),
        "hyperparameters": {
            "lr": 1e-4, "num_train_steps": 400_000, "warmup_steps": 100,
            "weight_decay": 0.01, "clip_norm": 5.0,
            "batch_size": args.batch_size,
            "input_duplication_factor": dataloader.input_duplication_factor,
            "finetuning_split": args.finetuning_split,
            "epochs": args.epochs, "seed": args.seed,
        },
        "vocab_size": vocab,
        "epochs_ran": len(history.history.get("loss", [])),
        "resumed": bool(args.resume),
        "wall_seconds": time.time() - t0,
        "results": _floats(results),
        "results_popularity_floor": _floats(floor),
        **({"results_full_ranking": _floats(full_results)}
           if full_results is not None else {}),
    })
    return 0


# --smoke presets: synthetic next-in-cycle data, sized for a seconds-long
# CPU self-test or for a run on the card at the ml-1m_128 shape (catalog
# 3706, seq 200, batch 256). JAX's values, one for one.
_SMOKE_PRESETS = {
    "tiny": dict(n_items=40, seq=16, max_pred=4, mask_rate=0.3,
                 train_rows=384, test_rows=64, epochs=60, batch_size=64,
                 lr=1e-2, sample_size=20, model=dict(
                     hidden_size=48, num_layers=2, num_attention_heads=4,
                     inner_dim=96)),
    "ml1m": dict(n_items=3706, seq=200, max_pred=40, mask_rate=0.2,
                 train_rows=8192, test_rows=1024, epochs=15, batch_size=256,
                 lr=1e-3, sample_size=100, model=dict(
                     hidden_size=128, num_layers=2, num_attention_heads=4,
                     inner_dim=512)),
    # the ML-20M catalog: the vocab-tiled loss inside the quality loop
    "ml20m": dict(n_items=26729, seq=200, max_pred=40, mask_rate=0.2,
                  train_rows=8192, test_rows=1024, epochs=15,
                  batch_size=256, lr=1e-3, sample_size=100, model=dict(
                      hidden_size=128, num_layers=2, num_attention_heads=4,
                      inner_dim=512)),
    # the Reddit catalog (335k items): sequences cycle over a 4k active
    # subset while the softmax and the evaluation span the whole catalog;
    # the epochs and the wider init get the model past the ln(active)
    # saddle of a softmax far wider than the active set
    "reddit": dict(n_items=335420, active_items=4096, seq=200, max_pred=40,
                   mask_rate=0.2, train_rows=4096, test_rows=512,
                   epochs=80, batch_size=256, lr=1e-3, sample_size=100,
                   model=dict(hidden_size=128, num_layers=2,
                              num_attention_heads=4, inner_dim=512,
                              initializer_range=0.1)),
}


def run_smoke(args, *, device="cuda"):
    """The end-to-end self-test on synthetic next-in-cycle data: the model
    must reach HR@10 > 0.5 and beat the popularity floor."""
    import numpy as np
    from bert4rec_tpu_torch.core.device import resolve_device
    from bert4rec_tpu_torch.dataloaders import samplers
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset,
    )
    from bert4rec_tpu_torch.evaluation import (
        BERT4RecEvaluator, PopularityScorer,
    )
    from bert4rec_tpu_torch.models import (
        BERT4RecConfig, BERT4RecModel, SASRecModel,
    )
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers

    device = resolve_device(device)
    on_card = device.type == "cuda"
    ps = _SMOKE_PRESETS[args.smoke_scale]
    n_items, seq = ps["n_items"], ps["seq"]
    vocab = n_items + 3
    sasrec = args.smoke_family == "sasrec"
    active = ps.get("active_items", n_items)

    def markov(n, sd):
        r = np.random.default_rng(sd)
        return [((np.arange(int(r.integers(seq // 2, seq + 1)))
                  + int(r.integers(0, active))) % active + 3)
                .astype(np.int32) for _ in range(n)]

    cfg = MaskingConfig(max_seq_len=seq,
                        max_predictions_per_seq=ps["max_pred"],
                        mask_token_id=1, pad_token_id=0, unk_token_id=2,
                        masked_lm_rate=ps["mask_rate"])
    task = "next_item" if sasrec else "mlm"
    n_train = ps["train_rows"]
    train = ProcessedDataset(markov(n_train, 0), cfg, lambda: vocab,
                             finetuning=np.zeros(n_train, bool), task=task)
    test_rows = markov(ps["test_rows"], 1)
    test = ProcessedDataset(test_rows, cfg, lambda: vocab,
                            finetuning=np.ones(len(test_rows), bool),
                            task=task)

    model_cls = SASRecModel if sasrec else BERT4RecModel
    model = model_cls(config=BERT4RecConfig(
        vocab_size=vocab, max_sequence_length=seq,
        max_predictions_per_seq=ps["max_pred"],
        use_fused_layer=on_card, use_fused_loss=on_card, **ps["model"]))
    trainer = BERT4RecTrainer(model, steps_per_call=4 if on_card else 1)
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=ps["lr"], num_train_steps=20_000, num_warmup_steps=50),
        seed=args.seed, device=device)
    t0 = time.time()
    trainer.train(train, epochs=ps["epochs"], batch_size=ps["batch_size"],
                  verbose=False, seed=args.seed)

    source = [int(t) for s in test_rows for t in s]

    def make_evaluator():
        return BERT4RecEvaluator(
            sampler=samplers.get("pop_random", source=source,
                                 vocab=list(dict.fromkeys(source)),
                                 sample_size=ps["sample_size"], seed=0),
            sample_size=ps["sample_size"])

    results = make_evaluator().evaluate(model, trainer.params, test,
                                        batch_size=ps["batch_size"],
                                        progress_bar=False)
    # the popularity floor under the same protocol: what makes the
    # model's number mean something
    floor = make_evaluator().evaluate(
        PopularityScorer.from_source(source, vocab, device=device), None,
        test, batch_size=ps["batch_size"], progress_bar=False)
    if not results["HR@10"] > 0.5:
        raise AssertionError(f"smoke run failed to learn: {results}")
    if not results["HR@10"] > floor["HR@10"]:
        raise AssertionError(f"model does not beat the popularity floor: "
                             f"{results} vs {floor}")
    out_default = f"{OUT_PREFIX}/smoke"
    if args.smoke_scale != "tiny":
        out_default += f"_{args.smoke_scale}"
    if sasrec:
        out_default += "_sasrec"
    emit(args.out or out_default, {
        "dataset": f"synthetic-markov (smoke, {args.smoke_scale}, "
                   f"{args.smoke_family})",
        "encoder_config": ("tiny" if args.smoke_scale == "tiny"
                           else "ml-1m_128-shaped"),
        "platform": platform_name(device),
        "hyperparameters": {"epochs": ps["epochs"],
                            "batch_size": ps["batch_size"],
                            "lr": ps["lr"],
                            "sample_size": ps["sample_size"]},
        "vocab_size": vocab,
        "wall_seconds": time.time() - t0,
        "results": _floats(results),
        "results_popularity_floor": _floats(floor),
    })
    return 0


# --oracle presets: the benchmark at CPU-test scale and at the ml-1m_128
# encoder shape and wider catalogs (on the card). alpha=0.6 puts the Bayes
# ceiling near HR@10 0.8, far from 1.0. ``gates``: the model/oracle ratio
# thresholds, set by the JAX package just under the ratios it measured on
# its TPU (quality_runs/oracle_*). JAX's values, one for one.
_ORACLE_PRESETS = {
    "tiny": dict(n_items=512, branching=8, alpha=0.6, zipf_s=1.1,
                 seq=32, max_pred=8, mask_rate=0.3, train_rows=3000,
                 test_rows=512, min_len=16, epochs=40, batch_size=128,
                 lr=1e-3, sample_size=100,
                 gates=dict(hr10=0.85, ndcg10=0.80),
                 model=dict(
                     hidden_size=64, num_layers=2, num_attention_heads=4,
                     inner_dim=128)),
    # JAX's gap-vs-epochs curve: HR ratio 0.746/0.925/0.969/0.976 and NDCG
    # 0.681/0.858/0.927/0.945 at 10/20/40/80 epochs; gates just under the
    # 80-epoch point
    "ml1m": dict(n_items=3706, branching=8, alpha=0.6, zipf_s=1.1,
                 seq=200, max_pred=40, mask_rate=0.2, train_rows=8192,
                 test_rows=1024, min_len=40, epochs=80, batch_size=256,
                 lr=1e-3, sample_size=100,
                 gates=dict(hr10=0.94, ndcg10=0.91),
                 model=dict(
                     hidden_size=128, num_layers=2, num_attention_heads=4,
                     inner_dim=512)),
    # the ML-20M catalog: the vocab-tiled loss inside the gate; more rows,
    # for 8x the transition rows to estimate. full_ndcg10 gates the
    # unsampled protocol under --full-ranking
    "ml20m": dict(n_items=26729, branching=8, alpha=0.6, zipf_s=1.1,
                  seq=200, max_pred=40, mask_rate=0.2, train_rows=16384,
                  test_rows=1024, min_len=40, epochs=60, batch_size=256,
                  lr=1e-3, sample_size=100,
                  gates=dict(hr10=0.92, ndcg10=0.88, full_ndcg10=0.87),
                  model=dict(
                      hidden_size=128, num_layers=2, num_attention_heads=4,
                      inner_dim=512)),
    # the Reddit catalog (335,420 items): the widest softmax the reference
    # ships. Tail contexts unseen in ~2M training tokens bound this scale
    # below ml20m; the popularity-initialised bias and the wider init get
    # past the ln(n_observed) saddle
    "reddit": dict(n_items=335420, branching=8, alpha=0.6, zipf_s=1.1,
                   seq=200, max_pred=40, mask_rate=0.2, train_rows=16384,
                   test_rows=1024, min_len=40, epochs=60, batch_size=256,
                   lr=1e-3, sample_size=100,
                   gates=dict(hr10=0.89, ndcg10=0.85),
                   model=dict(hidden_size=128, num_layers=2,
                              num_attention_heads=4, inner_dim=512,
                              initializer_range=0.1)),
}


# gates of the temporal oracle family (run_oracle_temporal). NDCG@10 and
# HR@1 discriminate: the blind marginal spreads mass over both routed
# contexts' supports, so HR@10 against sampled negatives barely separates
# the ceilings. `beat_blind` gates the model above the time-blind Bayes
# ceiling; the ablation margin gates time usage everywhere. `epochs`
# overrides the preset's budget (tiny: the 480-epoch point of JAX's
# budget curve). JAX's values, one for one.
_TEMPORAL_ORACLE_GATES = {
    "tiny": dict(ndcg10=0.90, hr1=0.85, ablation_margin=0.03,
                 beat_blind=False, epochs=480),
    "ml1m": dict(ndcg10=0.93, hr1=0.91, ablation_margin=0.04,
                 beat_blind=False),
    "ml20m": dict(ndcg10=0.91, hr1=0.89, ablation_margin=0.04,
                  beat_blind=False),
    "reddit": dict(ndcg10=0.86, hr1=0.81, ablation_margin=0.07,
                   beat_blind=False),
}


def _oracle_trainer(model, ps, counts, seed, device):
    """A trainer of ``model`` as the harness trains its oracle models:
    params from ``seed`` with the output bias at the log popularity prior,
    AdamW at the preset's lr, 4 steps a call on the card."""
    import torch
    from bert4rec_tpu_torch.models import model_utils
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
    params = model_utils.init_output_bias_from_popularity(
        model.init(torch.Generator().manual_seed(seed), device), counts)
    trainer = BERT4RecTrainer(
        model, steps_per_call=4 if device.type == "cuda" else 1)
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=ps["lr"], num_train_steps=400_000,
            num_warmup_steps=100),
        params=params, seed=seed, device=device)
    return trainer


def _full_ranking_block(model, params, test, ps):
    """The model's metrics under the unsampled protocol and its ms per
    batch on a second pass."""
    from bert4rec_tpu_torch.evaluation import BERT4RecEvaluator
    ev_full = BERT4RecEvaluator(full_ranking=True)
    res_full = ev_full.evaluate(model, params, test,
                                batch_size=ps["batch_size"],
                                progress_bar=False)
    n_batches = -(-ps["test_rows"] // ps["batch_size"])
    t_fr = time.time()
    ev_full.evaluate(model, params, test, batch_size=ps["batch_size"],
                     progress_bar=False)
    ms_per_batch = (time.time() - t_fr) * 1000 / n_batches
    return res_full, {"results": _floats(res_full),
                      "ms_per_batch": round(ms_per_batch, 2),
                      "batch_size": ps["batch_size"]}


def run_oracle_temporal(args, *, device="cuda"):
    """The temporal family's twin of run_oracle: the same protocol and
    presets, a time-routed planted law with two ceilings (temporal and
    time-blind Bayes); the train-side broken variant is the identically
    trained time-blind ablation, bounded by its own ceiling."""
    import numpy as np
    from bert4rec_tpu_torch.core.device import resolve_device
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset,
    )
    from bert4rec_tpu_torch.evaluation import PopularityScorer
    from bert4rec_tpu_torch.evaluation.markov_oracle import (
        evaluate_scorer, fits_host_dense,
    )
    from bert4rec_tpu_torch.evaluation.temporal_oracle import (
        TemporalMarkovCatalog, TemporalOracleScorer,
        host_full_ranking_temporal_oracle,
    )
    from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel

    if args.gap_curve:
        raise SystemExit(
            "--gap-curve is not implemented for --oracle-family temporal "
            "(it would silently no-op); use the bert4rec/sasrec oracle "
            "families for it, or drop the flag")
    device = resolve_device(device)
    on_card = device.type == "cuda"
    ps = dict(_ORACLE_PRESETS[args.oracle_scale])
    gates = _TEMPORAL_ORACLE_GATES[args.oracle_scale]
    if "epochs" in gates:  # the family's own budget (see the gate table)
        ps["epochs"] = gates["epochs"]
    if args.oracle_epochs:
        ps["epochs"] = args.oracle_epochs
    t0 = time.time()
    cat = TemporalMarkovCatalog(
        n_items=ps["n_items"], branching=ps["branching"],
        alpha=ps["alpha"], zipf_s=ps["zipf_s"], seed=args.seed)
    train_seqs, train_ts = cat.sample_sequences(
        ps["train_rows"], ps["min_len"], ps["seq"], seed=args.seed + 1)
    test_seqs, test_ts = cat.sample_sequences(
        ps["test_rows"], ps["min_len"], ps["seq"], seed=args.seed + 2)
    cfg = MaskingConfig(max_seq_len=ps["seq"],
                        max_predictions_per_seq=ps["max_pred"],
                        mask_token_id=1, pad_token_id=0, unk_token_id=2,
                        masked_lm_rate=ps["mask_rate"])
    test = ProcessedDataset(test_seqs, cfg, lambda: cat.vocab_size,
                            finetuning=np.ones(len(test_seqs), bool),
                            timestamps=test_ts)
    source = [int(t) for s in train_seqs for t in s]
    counts = np.bincount(source, minlength=cat.vocab_size)
    ekw = dict(source=source, sample_size=ps["sample_size"], seed=0,
               batch_size=ps["batch_size"])

    def train_model(temporal, tag):
        train = ProcessedDataset(train_seqs, cfg, lambda: cat.vocab_size,
                                 timestamps=train_ts)
        model = BERT4RecModel(config=BERT4RecConfig(
            vocab_size=cat.vocab_size, max_sequence_length=ps["seq"],
            max_predictions_per_seq=ps["max_pred"],
            use_fused_layer=on_card, use_fused_loss=on_card,
            use_temporal_embeddings=temporal,
            use_temporal_attention=temporal, **ps["model"]))
        trainer = _oracle_trainer(model, ps, counts, args.seed, device)
        trainer.train(train, epochs=ps["epochs"],
                      batch_size=ps["batch_size"], verbose=False,
                      seed=args.seed)
        res = evaluate_scorer(model, trainer.params, test, **ekw)
        print(f"[temporal-oracle] {tag}: {_r4(res)}", flush=True)
        return res, model, trainer.params

    def scorer(**kw):
        return TemporalOracleScorer(cat, device=device, **kw)

    oracle = evaluate_scorer(scorer(), None, test, **ekw)
    print(f"[temporal-oracle] temporal bayes ceiling: {_r4(oracle)}")
    blind = evaluate_scorer(scorer(time_blind=True), None, test, **ekw)
    print(f"[temporal-oracle] time-blind bayes ceiling: {_r4(blind)}")
    floor = evaluate_scorer(
        PopularityScorer.from_source(source, cat.vocab_size, device=device),
        None, test, **ekw)
    off_by_one = evaluate_scorer(scorer(context_offset=-1), None, test,
                                 **ekw)
    shuffled = evaluate_scorer(scorer(), None, test, sampler="random",
                               **ekw)

    res_model, model_obj, model_params = train_model(True,
                                                     "temporal model")
    res_ablation, _, _ = train_model(False, "time-blind ablation")

    full_block = None
    if args.full_ranking:
        # both Bayes ceilings from the host dense law where it fits, so
        # the full protocol keeps the two-ceiling bracket
        res_full, full_block = _full_ranking_block(model_obj, model_params,
                                                   test, ps)
        if fits_host_dense(cat):
            fr_oracle, _ = host_full_ranking_temporal_oracle(
                cat, test, batch_size=ps["batch_size"])
            fr_blind, _ = host_full_ranking_temporal_oracle(
                cat, test, time_blind=True, batch_size=ps["batch_size"])
            full_block["results_temporal_bayes_ceiling"] = _floats(fr_oracle)
            full_block["results_time_blind_bayes_ceiling"] = _floats(
                fr_blind)
            full_block["oracle_gap"] = {
                "NDCG@10_ratio": round(
                    float(res_full["NDCG@10"])
                    / max(float(fr_oracle["NDCG@10"]), 1e-9), 4),
                "model_minus_blind_ceiling_ndcg10": round(
                    float(res_full["NDCG@10"])
                    - float(fr_blind["NDCG@10"]), 4)}
        else:
            full_block["results_temporal_bayes_ceiling"] = (
                "skipped: dense [V, V] law exceeds host RAM at "
                f"vocab {cat.vocab_size}")
        print(f"[temporal-oracle] full-ranking: {_r4(res_full)} "
              f"({full_block['ms_per_batch']:.1f} ms/batch)", flush=True)

    int8 = (int8_block(model_obj, model_params, test, ekw, res_model,
                       "temporal-oracle", hr=False) if args.int8 else None)

    o_ndcg = float(oracle["NDCG@10"])
    b_ndcg = float(blind["NDCG@10"])
    ndcg_ratio = float(res_model["NDCG@10"]) / max(o_ndcg, 1e-9)
    hr1_ratio = float(res_model["HR@1"]) / max(float(oracle["HR@1"]),
                                               1e-9)
    checks = {
        "oracle_non_saturated": 0.5 <= float(oracle["HR@10"]) <= 0.95,
        "oracle_clears_floor":
            o_ndcg >= float(floor["NDCG@10"]) + 0.1,
        "time_signal_exists": o_ndcg >= b_ndcg + 0.03,
        f"model_reaches_{round(gates['ndcg10'] * 100)}"
        "pct_of_oracle_ndcg10": ndcg_ratio >= gates["ndcg10"],
        f"model_reaches_{round(gates['hr1'] * 100)}pct_of_oracle_hr1":
            hr1_ratio >= gates["hr1"],
        "model_uses_time_vs_ablation":
            float(res_model["NDCG@10"])
            >= float(res_ablation["NDCG@10"]) + gates["ablation_margin"],
        "ablation_bounded_by_blind_ceiling":
            float(res_ablation["NDCG@10"]) <= b_ndcg + 0.03,
        "model_does_not_beat_bayes":
            float(res_model["NDCG@10"]) <= o_ndcg + 0.03,
        "off_by_one_collapses":
            float(off_by_one["NDCG@10"]) <= o_ndcg - 0.05,
        "shuffled_negatives_inflate":
            float(shuffled["HR@10"]) >= float(oracle["HR@10"]) + 0.01,
    }
    if gates.get("beat_blind"):
        # the model above the best possible time-blind scorer, not only
        # above its own ablation
        checks["model_beats_blind_bayes_ceiling"] = (
            float(res_model["NDCG@10"]) >= b_ndcg + 0.01)
    if full_block is not None and "oracle_gap" in full_block:
        checks["full_ranking_does_not_beat_bayes"] = (
            float(full_block["results"]["NDCG@10"])
            <= float(full_block["results_temporal_bayes_ceiling"]
                     ["NDCG@10"]) + 0.03)
    if int8 is not None:
        gate_int8(checks, int8, gates)
    emit(args.out or f"{OUT_PREFIX}/oracle_{args.oracle_scale}_temporal", {
        "dataset": f"temporal markov-oracle benchmark "
                   f"({args.oracle_scale})",
        "platform": platform_name(device),
        "generator": {
            **{k: ps[k] for k in ("n_items", "branching", "alpha",
                                  "zipf_s", "seq", "mask_rate",
                                  "train_rows", "test_rows", "epochs")},
            "gaps_s": list(cat.gaps)},
        "wall_seconds": time.time() - t0,
        "results": _floats(res_model),
        "results_temporal_bayes_ceiling": _floats(oracle),
        "results_time_blind_bayes_ceiling": _floats(blind),
        "results_time_blind_ablation": _floats(res_ablation),
        "results_popularity_floor": _floats(floor),
        "results_broken_off_by_one": _floats(off_by_one),
        "results_broken_shuffled_negatives": _floats(shuffled),
        "oracle_gap": {
            "NDCG@10_ratio": round(ndcg_ratio, 4),
            "HR@1_ratio": round(hr1_ratio, 4),
            "model_minus_blind_ceiling_ndcg10":
                round(float(res_model["NDCG@10"]) - b_ndcg, 4),
            "model_minus_ablation_ndcg10":
                round(float(res_model["NDCG@10"])
                      - float(res_ablation["NDCG@10"]), 4)},
        "gates": gates,
        **({"results_full_ranking": full_block}
           if full_block is not None else {}),
        **({"results_int8": int8} if int8 is not None else {}),
        "checks": checks,
    })
    ok = all(checks.values())
    print(json.dumps({"temporal_oracle_checks_passed": ok, **checks}))
    return 0 if ok else 1


# the planted world of JAX's run_smoke_temporal (:747-870)
N_ITEMS, SEQ, WARMUP = 512, 48, 24
T0_DELTA = 86_400                 # "one day before"
GAPS = (3_600, 43_200)            # bimodal gaps: 1 h or 12 h
TRAIN_ROWS, TEST_ROWS, EPOCHS = 3072, 512, 30


def copy_by_time_delta(n, seed, n_items=N_ITEMS, seq=SEQ, warmup=WARMUP):
    """``n`` sequences of 40..``seq`` events whose item at position
    i >= ``warmup`` repeats the earlier item whose timestamp lies closest
    to one day before event i (JAX's ``gen``, the same draws in the same
    order). Returns ``(sequences, timestamps)``: int32 and int64 arrays."""
    import numpy as np
    vocab = n_items + 3
    r = np.random.default_rng(seed)
    seqs, tss = [], []
    for _ in range(n):
        ln = int(r.integers(40, seq + 1))
        gaps = r.choice(list(GAPS), size=ln)
        ts = (1_600_000_000 + np.cumsum(gaps)).astype(np.int64)
        items = r.integers(3, vocab, size=ln).astype(np.int32)
        for i in range(warmup, ln):
            j = int(np.argmin(np.abs((ts[i] - T0_DELTA) - ts[:i])))
            items[i] = items[j]
        seqs.append(items)
        tss.append(ts)
    return seqs, tss


def run_smoke_temporal(args, *, device="cuda"):
    """Temporal-family quality gate: the planted copy-by-time-delta rule
    (item_i repeats the earlier item closest to one day before t_i) that a
    relative-time bias can express and a time-blind model cannot, since
    "one day ago" lands 2..24 positions back. Both models (temporal, and
    the identically trained time-blind ablation) rank the ground truth
    against the whole catalog with nothing excluded, so the other seen
    items compete. Gates: temporal HR@1 >= 0.6, at least 0.25 above the
    ablation's, and at least 1.5 times it. ``args`` carries ``seed`` and
    ``out`` (the result's directory). Returns 0 when every check holds.
    On the card the layers and the loss run their kernels (the fused
    layer's K1'' rel_bias and K2 dRel in the temporal model), as JAX runs
    them on the TPU; the CPU runs their plain versions."""
    import numpy as np
    import torch
    from bert4rec_tpu_torch.core.device import resolve_device
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset,
    )
    from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers

    device = resolve_device(device)
    on_card = device.type == "cuda"
    vocab = N_ITEMS + 3
    cfg = MaskingConfig(max_seq_len=SEQ, max_predictions_per_seq=12,
                        mask_token_id=1, pad_token_id=0, unk_token_id=2,
                        masked_lm_rate=0.3)
    train_seqs, train_ts = copy_by_time_delta(TRAIN_ROWS, 0)
    test_seqs, test_ts = copy_by_time_delta(TEST_ROWS, 1)
    train = ProcessedDataset(train_seqs, cfg, lambda: vocab,
                             finetuning=np.zeros(len(train_seqs), bool),
                             timestamps=train_ts)
    test = ProcessedDataset(test_seqs, cfg, lambda: vocab,
                            finetuning=np.ones(len(test_seqs), bool),
                            timestamps=test_ts)

    def train_model(temporal: bool):
        model = BERT4RecModel(config=BERT4RecConfig(
            vocab_size=vocab, max_sequence_length=SEQ,
            max_predictions_per_seq=12, hidden_size=64, num_layers=2,
            num_attention_heads=4, inner_dim=128,
            use_fused_layer=on_card, use_fused_loss=on_card,
            use_temporal_embeddings=temporal,
            use_temporal_attention=temporal))
        trainer = BERT4RecTrainer(model)
        trainer.initialize_model(
            optimizer=optimizers.create_adam_w_optimizer(
                init_lr=3e-3, num_train_steps=20_000, num_warmup_steps=50),
            seed=args.seed, device=device)
        trainer.train(train, epochs=EPOCHS, batch_size=128, verbose=False,
                      seed=args.seed)
        return model, trainer.params

    def rank_metrics(model, params):
        """HR@k of the held-out ground truth against the whole catalog,
        nothing excluded: seen items compete."""
        ranks_all = []
        with torch.no_grad():
            for batch in test.batches(128, shuffle=False, seed=0):
                feats = {k: torch.from_numpy(np.ascontiguousarray(v))
                         .to(device) for k, v in batch.items()
                         if k not in ("labels", "example_weights")}
                r = model.gt_ranks_full_vocab(params, feats, exclude=None)
                w = np.asarray(batch["masked_lm_weights"]) > 0
                ranks_all.append(r.cpu().numpy()[w])
        ranks = np.concatenate(ranks_all)
        return {f"HR@{k}": float((ranks <= k).mean()) for k in (1, 5, 10)}

    t0 = time.time()
    model_t, params_t = train_model(True)
    res_t = rank_metrics(model_t, params_t)
    print(f"[temporal-smoke] temporal model: {res_t}", flush=True)
    model_b, params_b = train_model(False)
    res_b = rank_metrics(model_b, params_b)
    print(f"[temporal-smoke] time-blind ablation: {res_b}", flush=True)

    # HR@1 discriminates: the copied item is a frequent in-sequence item,
    # so a time-blind prior still ranks it in the top 10, but only the
    # time signal ranks it first
    checks = {
        "temporal_learns_rule": res_t["HR@1"] >= 0.6,
        "ablation_cannot": res_t["HR@1"] >= res_b["HR@1"] + 0.25,
        "hr1_separates": res_t["HR@1"] >= 1.5 * max(res_b["HR@1"], 1e-6),
    }
    emit(args.out or f"{OUT_PREFIX}/smoke_temporal", {
        "dataset": "synthetic copy-by-time-delta (temporal smoke)",
        "platform": platform_name(device),
        "generator": {"n_items": N_ITEMS, "seq": SEQ, "warmup": WARMUP,
                      "t0_delta_s": T0_DELTA, "gaps_s": list(GAPS),
                      "train_rows": len(train_seqs), "epochs": EPOCHS},
        "protocol": "full-catalog GT rank, NO exclusions (seen items "
                    "compete; the exclusion protocols cannot "
                    "discriminate copy rules)",
        "wall_seconds": time.time() - t0,
        "results": res_t,
        "results_time_blind_ablation": res_b,
        "checks": checks,
    })
    print(json.dumps(checks))
    if not all(checks.values()):
        print("[temporal-smoke] GATE FAILED", file=sys.stderr)
        return 1
    return 0


# the causal family's overrides. The next-item task is deterministic (the
# same (input, target) pairs every epoch), so extra epochs memorise the
# training rows; JAX's remedy, dropout 0.3 at 120 epochs, is baked in at
# the wide catalogs, with gates just under what JAX measured with it.
# JAX's values, one for one.
_SASREC_ORACLE_PRESET_OVERRIDES = {
    "ml20m": dict(epochs=120, model_extra=dict(attention_dropout=0.3,
                                               output_dropout=0.3)),
    "reddit": dict(epochs=120, model_extra=dict(attention_dropout=0.3,
                                                output_dropout=0.3)),
}
_SASREC_ORACLE_GATE_OVERRIDES = {
    "ml20m": dict(hr10=0.93, ndcg10=0.89),
    "reddit": dict(hr10=0.87, ndcg10=0.81),
}


def run_oracle(args, *, device="cuda"):
    """The Markov-oracle benchmark of the bert4rec or sasrec family: the
    Bayes ceiling, the popularity floor, the broken variants, the trained
    model and the train-side broken model, and JAX's checks. Returns 0
    when every check holds."""
    import numpy as np
    from bert4rec_tpu_torch.core.device import resolve_device
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset,
    )
    from bert4rec_tpu_torch.evaluation import PopularityScorer
    from bert4rec_tpu_torch.evaluation.markov_oracle import (
        MarkovCatalog, MarkovOracleScorer, evaluate_scorer,
        fits_host_dense, host_full_ranking_oracle,
    )
    from bert4rec_tpu_torch.models import (
        BERT4RecConfig, BERT4RecModel, SASRecModel,
    )

    device = resolve_device(device)
    on_card = device.type == "cuda"
    ps = dict(_ORACLE_PRESETS[args.oracle_scale])
    sasrec = args.oracle_family == "sasrec"
    if sasrec:
        over = dict(_SASREC_ORACLE_PRESET_OVERRIDES.get(
            args.oracle_scale, {}))
        extra = over.pop("model_extra", None)
        ps.update(over)
        if extra:
            ps["model"] = {**ps["model"], **extra}
    if args.oracle_epochs:
        ps["epochs"] = args.oracle_epochs
    # next-item protocol: the predicted position holds its own context
    # item (the label is the following item), so the Bayes oracle
    # conditions one step later than under MLM, where the position holds
    # [MASK] and the context is the token before it
    task = "next_item" if sasrec else "mlm"
    ctx = 1 if sasrec else 0
    t0 = time.time()
    cat = MarkovCatalog(n_items=ps["n_items"], branching=ps["branching"],
                        alpha=ps["alpha"], zipf_s=ps["zipf_s"],
                        seed=args.seed)
    train_seqs = cat.sample_sequences(ps["train_rows"], ps["min_len"],
                                      ps["seq"], seed=args.seed + 1)
    test_seqs = cat.sample_sequences(ps["test_rows"], ps["min_len"],
                                     ps["seq"], seed=args.seed + 2)
    cfg = MaskingConfig(max_seq_len=ps["seq"],
                        max_predictions_per_seq=ps["max_pred"],
                        mask_token_id=1, pad_token_id=0, unk_token_id=2,
                        masked_lm_rate=ps["mask_rate"])
    test = ProcessedDataset(test_seqs, cfg, lambda: cat.vocab_size,
                            finetuning=np.ones(len(test_seqs), bool),
                            task=task)
    source = [int(t) for s in train_seqs for t in s]
    counts = np.bincount(source, minlength=cat.vocab_size)
    ekw = dict(source=source, sample_size=ps["sample_size"], seed=0,
               batch_size=ps["batch_size"])

    def train_model(mask_rate, tag, model_cls=None, epochs=None):
        mcfg = MaskingConfig(max_seq_len=ps["seq"],
                             max_predictions_per_seq=ps["max_pred"],
                             mask_token_id=1, pad_token_id=0,
                             unk_token_id=2, masked_lm_rate=mask_rate)
        train = ProcessedDataset(train_seqs, mcfg, lambda: cat.vocab_size,
                                 task=task)
        if model_cls is None:
            model_cls = SASRecModel if sasrec else BERT4RecModel
        model = model_cls(config=BERT4RecConfig(
            vocab_size=cat.vocab_size, max_sequence_length=ps["seq"],
            max_predictions_per_seq=ps["max_pred"],
            use_fused_layer=on_card, use_fused_loss=on_card, **ps["model"]))
        trainer = _oracle_trainer(model, ps, counts, args.seed, device)
        trainer.train(train, epochs=epochs or ps["epochs"],
                      batch_size=ps["batch_size"], verbose=False,
                      seed=args.seed)
        res = evaluate_scorer(model, trainer.params, test, **ekw)
        print(f"[oracle-bench] {tag}: {_r4(res)}", flush=True)
        return res, model, trainer.params

    def ratios(res, ceiling=None):
        ceiling = ceiling or oracle
        return {f"{k}_ratio": round(float(res[k])
                                    / max(float(ceiling[k]), 1e-9), 4)
                for k in ("HR@10", "NDCG@10")}

    oracle = evaluate_scorer(
        MarkovOracleScorer(cat, context_offset=ctx, device=device), None,
        test, **ekw)
    print(f"[oracle-bench] bayes oracle: {_r4(oracle)}")
    floor = evaluate_scorer(
        PopularityScorer.from_source(source, cat.vocab_size, device=device),
        None, test, **ekw)
    off_by_one = evaluate_scorer(
        MarkovOracleScorer(cat, context_offset=ctx - 1, device=device),
        None, test, **ekw)
    shuffled = evaluate_scorer(
        MarkovOracleScorer(cat, context_offset=ctx, device=device), None,
        test, sampler="random", **ekw)

    curve = None
    if args.gap_curve:
        # the oracle and the floor need no training: train a fresh model
        # per budget and chart the gap against the one oracle
        budgets = sorted({int(x) for x in args.gap_curve.split(",")})
        ps["epochs"] = budgets[-1]
        curve = []
        for e in budgets[:-1]:
            r, _, _ = train_model(ps["mask_rate"], f"curve epochs={e}",
                                  epochs=e)
            curve.append({"epochs": e, **ratios(r), "results": _floats(r)})

    res_model, model_obj, model_params = train_model(ps["mask_rate"],
                                                     "trained model")
    if curve is not None:
        curve.append({"epochs": ps["epochs"], **ratios(res_model),
                      "results": _floats(res_model)})
        print(json.dumps({"gap_curve": [
            {k: c[k] for k in ("epochs", "HR@10_ratio", "NDCG@10_ratio")}
            for c in curve]}))
    if sasrec:
        # the missing-causal-mask bug: a bidirectional model on the
        # next-item task sees each label in its own input and learns to
        # copy it, then collapses at evaluation, where the target is
        # dropped from the input
        res_broken_train, _, _ = train_model(
            ps["mask_rate"], "broken non-causal next-item",
            model_cls=BERT4RecModel)
        broken_train_key = "results_broken_noncausal"
        broken_train_check = "noncausal_leak_collapses"
    else:
        # a near-zero masking rate leaves one masked position a sequence:
        # ~7x less training signal at the same budget, which the benchmark
        # must see as a drop
        res_broken_train, _, _ = train_model(0.02,
                                             "broken masking-rate 0.02")
        broken_train_key = "results_broken_masking_rate"
        broken_train_check = "wrong_masking_rate_degrades"

    full_block = None
    if args.full_ranking:
        # the unsampled protocol; the Bayes ceiling from the host dense
        # law where it fits host memory (<= ML-20M width)
        res_full, full_block = _full_ranking_block(model_obj, model_params,
                                                   test, ps)
        if fits_host_dense(cat):
            full_oracle, _ = host_full_ranking_oracle(
                cat, test, context_offset=ctx, batch_size=ps["batch_size"])
            full_block["results_bayes_oracle"] = _floats(full_oracle)
            full_block["oracle_gap"] = ratios(res_full, full_oracle)
        else:
            full_block["results_bayes_oracle"] = (
                "skipped: dense [V, V] law exceeds host RAM at "
                f"vocab {cat.vocab_size}")
        print(f"[oracle-bench] full-ranking: {_r4(res_full)} "
              f"({full_block['ms_per_batch']:.1f} ms/batch)", flush=True)

    int8 = (int8_block(model_obj, model_params, test, ekw, res_model,
                       "oracle-bench") if args.int8 else None)

    gap = ratios(res_model)
    gap_hr = float(res_model["HR@10"]) / max(float(oracle["HR@10"]), 1e-9)
    gap_ndcg = (float(res_model["NDCG@10"])
                / max(float(oracle["NDCG@10"]), 1e-9))
    gates = dict(ps.get("gates", {}))
    if sasrec:
        gates.update(_SASREC_ORACLE_GATE_OVERRIDES.get(
            args.oracle_scale, {}))
    hr_gate = gates.get("hr10", 0.80)
    ndcg_gate = gates.get("ndcg10")
    checks = {
        "oracle_non_saturated": 0.5 <= float(oracle["HR@10"]) <= 0.95,
        "oracle_clears_floor":
            float(oracle["HR@10"]) >= float(floor["HR@10"]) + 0.1,
        f"model_reaches_{round(hr_gate * 100)}pct_of_oracle_hr10":
            gap_hr >= hr_gate,
        "model_does_not_beat_bayes":
            float(res_model["HR@10"]) <= float(oracle["HR@10"]) + 0.05,
        "off_by_one_collapses":
            float(off_by_one["HR@10"]) <= 0.8 * float(oracle["HR@10"]),
        "shuffled_negatives_inflate":
            float(shuffled["HR@10"]) >= float(oracle["HR@10"]) + 0.01,
        broken_train_check:
            float(res_broken_train["HR@10"])
            <= float(res_model["HR@10"]) - 0.03,
    }
    if ndcg_gate is not None:
        checks[f"model_reaches_{round(ndcg_gate * 100)}"
               "pct_of_oracle_ndcg10"] = gap_ndcg >= ndcg_gate
    if int8 is not None:
        gate_int8(checks, int8, gates)
    if full_block is not None and "oracle_gap" in full_block:
        # the model cannot beat the Bayes ceiling under the full protocol
        # either, and the preset may pin a floor (full_ndcg10)
        checks["full_ranking_does_not_beat_bayes"] = (
            float(full_block["results"]["HR@10"])
            <= float(full_block["results_bayes_oracle"]["HR@10"]) + 0.05)
        fr_gate = gates.get("full_ndcg10")
        if fr_gate is not None:
            checks[f"full_ranking_reaches_{round(fr_gate * 100)}"
                   "pct_of_oracle_ndcg10"] = (
                full_block["oracle_gap"]["NDCG@10_ratio"] >= fr_gate)
    out_default = f"{OUT_PREFIX}/oracle_{args.oracle_scale}"
    if sasrec:
        out_default += "_sasrec"
    emit(args.out or out_default, {
        "dataset": f"markov-oracle benchmark ({args.oracle_scale}, "
                   f"{args.oracle_family})",
        "platform": platform_name(device),
        "generator": {k: ps[k] for k in
                      ("n_items", "branching", "alpha", "zipf_s", "seq",
                       "mask_rate", "train_rows", "test_rows", "epochs")},
        "wall_seconds": time.time() - t0,
        "results": _floats(res_model),
        "results_bayes_oracle": _floats(oracle),
        "results_popularity_floor": _floats(floor),
        "results_broken_off_by_one": _floats(off_by_one),
        "results_broken_shuffled_negatives": _floats(shuffled),
        broken_train_key: _floats(res_broken_train),
        "oracle_gap": gap,
        "gates": {"hr10": hr_gate, "ndcg10": ndcg_gate},
        **({"gap_curve": curve} if curve is not None else {}),
        **({"results_full_ranking": full_block}
           if full_block is not None else {}),
        **({"results_int8": int8} if int8 is not None else {}),
        "checks": checks,
    })
    ok = all(checks.values())
    print(json.dumps({"oracle_checks_passed": ok, **checks}))
    return 0 if ok else 1


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.oracle and args.oracle_family == "temporal":
        return run_oracle_temporal(args, device=args.device)
    if args.oracle:
        return run_oracle(args, device=args.device)
    if args.smoke and args.smoke_family == "temporal":
        return run_smoke_temporal(args, device=args.device)
    if args.smoke:
        return run_smoke(args, device=args.device)
    return run_real(args, device=args.device)
