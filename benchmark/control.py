"""Readings of the correctness check's control and planted faults, at a
cell's own size. For each seed the reference follows three
steps from the benchmark's weights over the program's masked batches in
float32 (the standard), in float8 (the control: every product's operands
rounded to e4m3, forward and backward) and over half of each batch (the
fault), and the two are compared with the standard as a program would
be.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13

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


def readings(conf: dict, traffic: dict, seed: int, device) -> dict:
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset)

    from benchmark import traffic_gen, weights
    from benchmark.reference import check, model
    cfg, train = conf["model"], conf["training"]
    seqs = traffic_gen.corpus(traffic, seed, device)
    dataset = ProcessedDataset(seqs, MaskingConfig(
        max_seq_len=cfg["max_sequence_length"],
        max_predictions_per_seq=cfg["max_predictions_per_seq"],
        mask_token_id=1, pad_token_id=0, unk_token_id=2,
        masked_lm_rate=train["masked_lm_rate"],
        mask_token_rate=train["mask_token_rate"],
        random_token_rate=train["random_token_rate"]),
        lambda: cfg["vocab_size"])
    keys = ("input_word_ids", "input_mask", "masked_lm_positions",
            "masked_lm_ids")
    import torch
    batches = []
    for host in dataset.batches(train["batch_size"], shuffle=True,
                                seed=seed, drop_remainder=True):
        batches.append({k: torch.from_numpy(host[k]) for k in keys})
        if len(batches) == 3:
            break
    init = {k: v.cpu() for k, v in weights.make(cfg, seed, device).items()}
    opt = conf["optimizer"]
    ref = check.follow(init, batches, cfg, opt, seed, device)
    low = check.follow(init, batches, cfg, opt, seed, device,
                       mm=model.mm_fp8)
    half = check.follow(init, batches, cfg, opt, seed, device, half=True)
    return {"seed": seed, "control_fp8": check.compare(low, ref),
            "half_batch": check.compare(half, ref)}


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
