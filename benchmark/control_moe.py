"""Readings of the correctness check's control and planted fault for the
``mla_moe`` cells, at a cell's own size. For each seed the reference
(``reference/mla_moe.py``) follows three steps from the benchmark's
weights over masked batches of the cell's traffic in float32 (the
standard, with its own expert selection), in float8 (the control: every
product's operands rounded to e4m3, forward and backward) and over half of
each batch (the fault), both following the standard's selection, and the
two are compared with the standard as a program would be. The routing
judge's planted faults are read in the standard's run: at every MoE layer
the selection without the bias, and the top k-1 and a random expert,
judged against the standard's scores (``judge_faults``, each a ``tally``).

    python3 benchmark/control_moe.py --workload <cell> --seeds 11 12 13

Prints one JSON line per seed. Run on the card; the benchmark's own runs
never run it.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _judging_faults(reference, seed: int) -> tuple:
    """A wrapper of ``reference.moe`` that judges the two planted faults'
    selections at each layer it runs, and their deficits by fault."""
    import torch
    found = {"without_bias": [], "top_k_less_1_and_random": []}
    gen = torch.Generator().manual_seed(seed)
    moe = reference.moe

    def judged(p, x, bias, sel, cfg, *args, **kwargs):
        with torch.no_grad():
            scores = reference.router_scores(p, x)
            units = reference.unit(p, x)
            k = cfg["num_experts_per_tok"]
            order = torch.argsort(scores + bias, -1, descending=True)
            at = torch.randint(k, scores.shape[-1], (scores.shape[0], 1),
                               generator=gen).to(scores.device)
            for name, pick in (
                    ("without_bias", torch.topk(scores, k, -1).indices),
                    ("top_k_less_1_and_random", torch.cat(
                        [order[:, :k - 1], order.gather(1, at)], -1))):
                found[name].append(
                    reference.judge(scores, bias, pick, units, k).cpu())
        return moe(p, x, bias, sel, cfg, *args, **kwargs)
    return judged, found


def readings(conf: dict, traffic: dict, seed: int, device) -> dict:
    import torch
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset)

    from benchmark import traffic_gen
    from benchmark.reference import check, model
    from benchmark.reference import mla_moe as reference
    cfg = dict(conf["model"], router_bias_seed=seed)
    train = conf["training"]
    seqs = traffic_gen.corpus(traffic, seed, device)
    dataset = ProcessedDataset(seqs, MaskingConfig(
        max_seq_len=cfg["max_sequence_length"],
        max_predictions_per_seq=cfg["max_predictions_per_seq"],
        mask_token_id=1, pad_token_id=0, unk_token_id=2),
        lambda: cfg["vocab_size"], task=traffic["task"])
    keys = ("input_word_ids", "input_mask", "masked_lm_positions",
            "masked_lm_ids")
    batches = []
    for host in dataset.batches(train["batch_size"], shuffle=True,
                                seed=seed, drop_remainder=True):
        batches.append({k: torch.from_numpy(host[k]) for k in keys})
        if len(batches) == 3:
            break
    init = {k: v.cpu() for k, v in
            reference.make_weights(cfg, seed, device).items()}
    opt, block = conf["optimizer"], train.get("reference_block_rows")
    original = reference.moe
    reference.moe, faults = _judging_faults(reference, seed)
    try:
        ref = reference.follow(init, batches, None, cfg, opt, device,
                               block_rows=block)
    finally:
        reference.moe = original
    sel = ref.pop("selections")
    low = reference.follow(init, batches, sel, cfg, opt, device,
                           mm=model.mm_fp8, block_rows=block)
    half = reference.follow(init, batches, sel, cfg, opt, device, half=True,
                            block_rows=block)
    return {"seed": seed, "control_fp8": check.compare(low, ref),
            "half_batch": check.compare(half, ref),
            "judge_faults": {k: reference.tally(torch.cat(v))
                             for k, v in faults.items()}}


def main(argv=None, device=None, adjust=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    from benchmark import harness
    _, _, conf, traffic = harness.cell(args.workload)
    if adjust is not None:
        adjust(conf, traffic)
    device = torch.device(device or "cuda")
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload,
                          **readings(conf, traffic, seed, device)}),
              flush=True)


if __name__ == "__main__":
    main()
