"""Dataloader API tour (port of ``examples/dataloader_usage_example.py``;
reference examples/dataloader_usage_example.py): factory -> vocab ->
LOO-split datasets -> fixed-shape feature batches, on the ML-1M corpus on
disk (under ``BERT4REC_TPU_HOME``); the first batch is placed on the
device as a trainer's step reads it::

    python -m bert4rec_tpu_torch.examples.dataloader_usage_example \\
        [--device cpu]
"""

import torch

from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.dataloaders import get_dataloader_factory
from bert4rec_tpu_torch.examples._common import command_line


def main(device="cuda") -> dict:
    device = resolve_device(device)
    factory = get_dataloader_factory("bert4rec")
    dataloader = factory.create_ml_1m_dataloader()

    # vocab generation (tokenizes every distinct item string)
    dataloader.generate_vocab()
    tokenizer = dataloader.get_tokenizer()
    print("vocab size:", tokenizer.get_vocab_size())

    # leave-one-out split + MLM preprocessing
    train_ds, val_ds, test_ds = dataloader.prepare_training(
        finetuning_split=0.1)
    print("train/val/test sizes:",
          len(train_ds), len(val_ds), len(test_ds))

    # fixed-shape int32 feature batches, fresh masks per epoch seed
    batch = next(train_ds.batches(batch_size=256, seed=0))
    for name, arr in batch.items():
        print(f"  {name}: {arr.shape} {arr.dtype}")
    placed = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    print("placed on", device, {k: tuple(v.shape) for k, v in placed.items()})

    # single-sequence inference features
    items = dataloader.create_item_list()[:5]
    model_input = dataloader.prepare_inference(items)
    print("inference features:",
          {k: v.shape for k, v in model_input.items()})
    return {"vocab_size": tokenizer.get_vocab_size(),
            "sizes": (len(train_ds), len(val_ds), len(test_ds)),
            "batch": batch, "inference": model_input}


if __name__ == "__main__":
    main(**command_line(__doc__))
