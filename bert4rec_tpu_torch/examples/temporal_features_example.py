"""Temporal features: aligned per-item timestamps through the pipeline
(port of ``examples/temporal_features_example.py``; reference
BERT4RecTemporalPreprocessor, bert4rec_temporal_preprocessor.py:59-160).
The feature dict gains an ``input_timestamps`` column truncated/padded in
lockstep with the items; two models consume it (recency-bucket
embeddings, and a relative time-interval attention bias)::

    python -m bert4rec_tpu_torch.examples.temporal_features_example \\
        [--device cpu]
"""

import numpy as np
import pandas as pd
import torch

from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader, preprocessors
from bert4rec_tpu_torch.examples._common import command_line
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel


def interactions(seed: int = 0) -> pd.DataFrame:
    """20 users' timestamped histories over 30 items."""
    rng = np.random.default_rng(seed)
    rows = []
    for uid in range(20):
        t = rng.integers(1_500_000_000, 1_600_000_000)
        for _ in range(int(rng.integers(5, 15))):
            rows.append((uid, f"item_{rng.integers(0, 30)}", int(t)))
            t += int(rng.integers(60, 86400))
    return pd.DataFrame(rows, columns=["uid", "item", "timestamp"])


@torch.inference_mode()
def main(device="cuda") -> dict:
    df = interactions()

    class InlineSource:
        @classmethod
        def load_data(cls):
            return df

    dataloader = BERT4RecDataloader(
        max_seq_len=16, max_predictions_per_seq=4,
        data_source=InlineSource,
        preprocessor=preprocessors.BERT4RecTemporalPreprocessor)
    dataloader.generate_vocab(sorted(set(df["item"])))

    train, val, test = dataloader.get_data(
        sort_by="timestamp", group_by="uid",
        extract_data=["item", "timestamp"], finetuning_split=0.1)

    batch = next(train.batches(8, seed=0))
    print("feature keys:", sorted(batch.keys()))
    if "input_timestamps" not in batch:
        raise RuntimeError("the temporal pipeline gave no input_timestamps")
    print("input_timestamps:", batch["input_timestamps"].shape,
          batch["input_timestamps"].dtype)
    # timestamps align with items: padded exactly where items are padded
    pad = batch["input_word_ids"] == 0
    if not (batch["input_timestamps"][pad] == 0).all():
        raise RuntimeError("timestamps are not padded where items are")
    print("timestamps aligned with item padding: OK")

    # single-sequence inference appends the current time for the [UNK] slot
    items = df[df.uid == 0].sort_values("timestamp")["item"].tolist()
    ts = df[df.uid == 0].sort_values("timestamp")["timestamp"].tolist()
    model_input = dataloader.preprocessor.prepare_inference(items, ts)
    print("inference features:", {k: v.shape for k, v in model_input.items()})

    # beyond parity: models that CONSUME the timestamps — learned
    # recency-bucket embeddings (the reference ships the temporal
    # preprocessor but no model uses it), and TiSASRec-style relative
    # time-interval ATTENTION: a learned per-head bias over signed log2
    # time-delta buckets between every query/key event pair
    # (zero-initialized — exact no-op until trained)
    inputs = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    out = {"batch": batch, "inference": model_input}
    for name, flag in (("temporal model", "use_temporal_embeddings"),
                       ("temporal-attention", "use_temporal_attention")):
        model = BERT4RecModel(config=BERT4RecConfig(
            vocab_size=dataloader.tokenizer.get_vocab_size(), hidden_size=32,
            num_layers=1, num_attention_heads=4, inner_dim=64,
            max_sequence_length=dataloader._MAX_SEQ_LENGTH,
            max_predictions_per_seq=dataloader._MAX_PREDICTIONS_PER_SEQ,
            **{flag: True}))
        params = model.init(torch.Generator().manual_seed(0), device=device)
        logits = model.apply(params, inputs)["mlm_logits"]
        print(f"{name} mlm_logits:", tuple(logits.shape))
        out[flag] = logits.cpu().numpy()
    return out


if __name__ == "__main__":
    main(**command_line(__doc__))
