"""Quality harness (port of ``bert4rec_tpu/evaluation/quality_harness.py``):
the temporal family's learning gate, ``run_smoke_temporal``, and the
``emit`` it writes its result with. The other modes (``run_smoke``,
``run_oracle``, ``run_oracle_temporal``) and the CLI come with the oracles.

    from types import SimpleNamespace
    run_smoke_temporal(SimpleNamespace(seed=42, out="/tmp/smoke_temporal"))

runs on the card by default (``device="cpu"`` runs the plain versions).
"""

import json
import pathlib
import sys
import time

# the planted world of JAX's run_smoke_temporal (:747-870)
N_ITEMS, SEQ, WARMUP = 512, 48, 24
T0_DELTA = 86_400                 # "one day before"
GAPS = (3_600, 43_200)            # bimodal gaps: 1 h or 12 h
TRAIN_ROWS, TEST_ROWS, EPOCHS = 3072, 512, 30


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
    emit(args.out or "quality_runs/torch_smoke_temporal", {
        "dataset": "synthetic copy-by-time-delta (temporal smoke)",
        "platform": ("gpu " + torch.cuda.get_device_name(device)) if on_card
        else "cpu",
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
