"""SASRec on the shared stack (port of ``examples/sasrec_example.py``;
BEYOND PARITY — the reference repo ships only BERT4Rec).

SASRec (Kang & McAuley, ICDM 2018) is a LEFT-TO-RIGHT transformer trained
on next-item prediction: no [MASK] token ever enters the input, closing
the train/inference gap. In this framework it is two switches on the
BERT4Rec machinery — ``preprocessor="sasrec"`` on the dataloader (the
``next_item`` dataset task) and ``SASRecModel`` (causal attention; on the
card the fused layer's causal kernels, by the route its shape law picks).
Trainer, evaluator, wrapper persistence and serving apps are all
inherited::

    python -m bert4rec_tpu_torch.examples.sasrec_example [--device cpu]
"""

import numpy as np
import pandas as pd
import torch

from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader, samplers
from bert4rec_tpu_torch.evaluation import BERT4RecEvaluator
from bert4rec_tpu_torch.examples._common import card_config, command_line
from bert4rec_tpu_torch.models import BERT4RecConfig, SASRecModel
from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers


def main(device="cuda") -> dict:
    # synthetic interactions with sequential structure: item i tends to be
    # followed by item (i + 1) % 30
    rng = np.random.default_rng(0)
    rows = []
    for uid in range(300):
        cur = int(rng.integers(0, 30))
        t = int(rng.integers(1_500_000_000, 1_600_000_000))
        for _ in range(int(rng.integers(6, 16))):
            rows.append((uid, f"item_{cur}", t))
            cur = (cur + 1) % 30
            t += 3600
    df = pd.DataFrame(rows, columns=["uid", "item", "timestamp"])

    class InlineSource:
        @classmethod
        def load_data(cls):
            return df

    dataloader = BERT4RecDataloader(
        max_seq_len=16, max_predictions_per_seq=8,
        data_source=InlineSource, preprocessor="sasrec")
    dataloader.generate_vocab(sorted(set(df["item"])))

    train, val, test = dataloader.get_data(
        sort_by="timestamp", group_by="uid", extract_data=["item"],
        finetuning_split=0.1)
    print("train task:", train.task)  # next_item: final item dropped,
    # every remaining position predicts its successor

    model = SASRecModel(config=card_config(BERT4RecConfig(
        vocab_size=dataloader.tokenizer.get_vocab_size(),
        hidden_size=48, num_layers=2, num_attention_heads=4, inner_dim=96,
        max_sequence_length=16, max_predictions_per_seq=8), device))
    print("causal attention:", model.config.causal_attention)

    trainer = BERT4RecTrainer(model)
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=5e-3, num_train_steps=5000, num_warmup_steps=50),
        seed=0, device=device)
    history = trainer.train(train, val_ds=val, epochs=15, batch_size=64,
                            verbose=False)
    accuracy = history.history["masked_accuracy"][-1]
    print(f"masked_accuracy: {accuracy:.3f}")

    # leave-one-out eval with sampled negatives (same protocol as BERT4Rec)
    source = [t for s in df.groupby("uid")["item"].apply(list) for t in s]
    sampler = samplers.get(
        "pop_random", source=dataloader.tokenizer.tokenize(source),
        vocab=dataloader.tokenizer.tokenize(sorted(set(source))),
        sample_size=20, seed=0)
    evaluator = BERT4RecEvaluator(sampler=sampler, sample_size=20)
    results = evaluator.evaluate(model, trainer.params, test,
                                 batch_size=32, progress_bar=False)
    print({k: round(float(v), 3) for k, v in results.items()})

    # next-item inference from a raw history: the appended placeholder is
    # dropped by the next_item task, so the prediction slot sits at the
    # last real item — SASRec's "predict from the last position"
    history_items = ["item_4", "item_5", "item_6"]
    feats = dataloader.prepare_inference(history_items)
    with torch.inference_mode():
        out = model.apply(trainer.params,
                          {k: torch.from_numpy(v).to(device)
                           for k, v in feats.items()})
    top = torch.argsort(out["mlm_logits"][0, 0], descending=True,
                        stable=True)[:3].cpu().numpy()
    after = [dataloader.tokenizer.detokenize(int(t)) for t in top]
    print("after", history_items, "->", after)
    return {"masked_accuracy": accuracy, "results": results, "after": after}


if __name__ == "__main__":
    main(**command_line(__doc__))
