"""Where a Markov-oracle preset's training on the kernels departs from the
same training on their plain versions, on one CUDA card:

    python bert4rec_tpu_torch/tools/oracle_drift.py --scale ml20m --steps 300
    python bert4rec_tpu_torch/tools/oracle_drift.py --scale ml20m --plain-run

The first form builds the preset's world and model as
``quality_harness.run_oracle`` does (family bert4rec, the same seeds) and
trains two copies of the model from the same params on the same batches
and dropout seeds: one on the fused layer and loss kernels, one with
every kernel call sent to its plain PyTorch version (``tools/
plain_kernels.py``). It prints the two losses' relative difference per step
(the largest so far at each of a few steps) and each parameter's distance
between the copies, relative to its scale, at those steps; then the same
for two plain copies whose second starts one float32 ulp away in every
parameter (how far training amplifies a rounding-sized difference), and
for two kernel copies (whether the kernel path repeats its bits). One
JSON line per checkpoint step.

``--plain-run`` runs the whole ``run_oracle`` at the preset with every
kernel call on its plain version (``--full-ranking``, output under
``--out``): the model the kernels would train if they computed exactly
the plain functions, gated as the kernel run is.
"""

import argparse
import json
import math
import pathlib
import sys
import time
from contextlib import ExitStack

REPO = pathlib.Path(__file__).resolve().parents[2]

CHECKPOINTS = (1, 3, 10, 30, 100, 300, 1000, 3000)


def plain(stack):
    """Enter the patches that send every kernel call to its plain
    version."""
    from bert4rec_tpu_torch.tools.plain_kernels import plain_kernels
    for patch in plain_kernels():
        stack.enter_context(patch)


def world(scale, seed, device):
    """The preset, its training set and a trainer factory, as
    ``run_oracle`` builds them on the card."""
    import numpy as np
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset,
    )
    from bert4rec_tpu_torch.evaluation import quality_harness as qh
    from bert4rec_tpu_torch.evaluation.markov_oracle import MarkovCatalog
    from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel

    ps = qh._ORACLE_PRESETS[scale]
    cat = MarkovCatalog(n_items=ps["n_items"], branching=ps["branching"],
                        alpha=ps["alpha"], zipf_s=ps["zipf_s"], seed=seed)
    seqs = cat.sample_sequences(ps["train_rows"], ps["min_len"], ps["seq"],
                                seed=seed + 1)
    cfg = MaskingConfig(max_seq_len=ps["seq"],
                        max_predictions_per_seq=ps["max_pred"],
                        mask_token_id=1, pad_token_id=0, unk_token_id=2,
                        masked_lm_rate=ps["mask_rate"])
    train = ProcessedDataset(seqs, cfg, lambda: cat.vocab_size)
    counts = np.bincount([int(t) for s in seqs for t in s],
                         minlength=cat.vocab_size)

    def new():
        model = BERT4RecModel(config=BERT4RecConfig(
            vocab_size=cat.vocab_size, max_sequence_length=ps["seq"],
            max_predictions_per_seq=ps["max_pred"], use_fused_layer=True,
            use_fused_loss=True, **ps["model"]))
        return qh._oracle_trainer(model, ps, counts, seed, device)

    return ps, train, new


def param_dist(torch, a, b) -> dict:
    """Each parameter's largest difference between two trainers, over its
    own largest magnitude."""
    from bert4rec_tpu_torch.utils.checkpoint import flatten
    fa, fb = flatten(a.state["params"]), flatten(b.state["params"])
    with torch.no_grad():
        return {k: float((fa[k] - fb[k]).abs().max())
                / max(float(fa[k].abs().max()), 1e-30) for k in fa}


def drift(torch, args, device):
    from bert4rec_tpu_torch.utils.checkpoint import flatten
    ps, train, new = world(args.scale, args.seed, device)
    nudged = new()
    with torch.no_grad():
        for p in flatten(nudged.state["params"]).values():
            p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
    pairs = {"kernels_vs_plain": (new(), new(), (False, True)),
             "plain_vs_plain_one_ulp": (new(), nudged, (True, True)),
             "kernels_vs_kernels": (new(), new(), (False, False))}
    worst = dict.fromkeys(pairs, 0.0)
    step, epoch, t0 = 0, 0, time.perf_counter()
    while step < args.steps:
        for host in train.batches(ps["batch_size"], shuffle=True,
                                  seed=args.seed + epoch):
            step += 1
            row = {"step": step}
            for name, (a, b, plains) in pairs.items():
                losses = []
                for trainer, on_plain in zip((a, b), plains):
                    with ExitStack() as stack:
                        if on_plain:
                            plain(stack)
                        losses.append(float(trainer.train_step(
                            trainer._put_batch(host))["loss"]))
                rel = abs(losses[0] - losses[1]) / abs(losses[1])
                worst[name] = max(worst[name], rel)
                if step in CHECKPOINTS or step == args.steps:
                    dist = param_dist(torch, a, b)
                    top = max(dist, key=dist.get)
                    row[name] = {"loss": losses,
                                 "max_loss_rel_so_far": worst[name],
                                 "max_param_rel": dist[top],
                                 "at": top,
                                 "median_param_rel": sorted(
                                     dist.values())[len(dist) // 2]}
            if len(row) > 1:
                row["seconds"] = round(time.perf_counter() - t0, 1)
                print(json.dumps(row), flush=True)
            if step >= args.steps:
                break
        epoch += 1


def main():
    sys.path.insert(0, str(REPO))
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scale", default="ml20m",
                   choices=["tiny", "ml1m", "ml20m", "reddit"])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--plain-run", action="store_true")
    p.add_argument("--out", default=None,
                   help="--plain-run's output dir (default: "
                        "quality_runs/torch/oracle_<scale>_plain)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    import torch
    from bert4rec_tpu_torch.core.device import resolve_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(args.device)
    if not args.plain_run:
        drift(torch, args, device)
        return 0
    from bert4rec_tpu_torch.evaluation import quality_harness as qh
    out = args.out or f"{qh.OUT_PREFIX}/oracle_{args.scale}_plain"
    run_args = qh.build_argparser().parse_args(
        ["--oracle", "--oracle-scale", args.scale, "--full-ranking",
         "--seed", str(args.seed), "--out", out])
    with ExitStack() as stack:
        plain(stack)
        return qh.run_oracle(run_args, device=device)


if __name__ == "__main__":
    sys.exit(main())
