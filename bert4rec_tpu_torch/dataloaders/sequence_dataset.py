"""Host-side sequence dataset.

Replaces the reference's ``tf.data.Dataset`` pipeline objects with a plain
numpy container: a list of variable-length item sequences (raw strings or
tokenized int32 arrays) plus optional aligned extra columns (timestamps).

Design: all heavy per-element work (tokenize/truncate/mask/pad) happens
*vectorized per batch* in :mod:`bert4rec_tpu_torch.dataloaders.dataloader_utils`,
not per element — this is where the reference bottlenecked
(tf.numpy_function + python loops, reference bert4rec_preprocessor.py:118-122).

Port of ``bert4rec_tpu/dataloaders/sequence_dataset.py``.
"""

from typing import Iterator, List, Optional

import numpy as np


class SequenceDataset:
    """A list of variable-length sequences with optional aligned columns."""

    def __init__(self, sequences: List, columns: Optional[dict] = None):
        """
        :param sequences: list of sequences; each sequence is a list/array of
            items (raw strings before tokenization, int ids after).
        :param columns: optional dict of aligned per-sequence lists (e.g.
            ``{"timestamps": [...]}``), same outer length as ``sequences``.
        """
        self.sequences = list(sequences)
        self.columns = columns or {}
        for name, col in self.columns.items():
            if len(col) != len(self.sequences):
                raise ValueError(
                    f"Aligned column {name!r} has length {len(col)} != "
                    f"{len(self.sequences)} sequences")

    def __len__(self) -> int:
        return len(self.sequences)

    def __iter__(self) -> Iterator:
        return iter(self.sequences)

    def __getitem__(self, idx):
        return self.sequences[idx]

    def cardinality(self) -> int:
        return len(self.sequences)

    def repeat(self, k: int) -> "SequenceDataset":
        """Duplicate every sequence k times (reference duplicate_dataset,
        dataloader_utils.py:177-183)."""
        if k < 1:
            raise ValueError(
                f"A duplication factor of less than 1 (given: {k}) is not "
                "allowed!")
        if k == 1:
            return self
        return SequenceDataset(
            self.sequences * k,
            {n: list(c) * k for n, c in self.columns.items()})

    def select(self, indices) -> "SequenceDataset":
        indices = np.asarray(indices)
        return SequenceDataset(
            [self.sequences[i] for i in indices],
            {n: [c[i] for i in indices] for n, c in self.columns.items()})

    def concatenate(self, other: "SequenceDataset") -> "SequenceDataset":
        cols = {}
        for name in self.columns:
            if name not in other.columns:
                raise ValueError(f"Column {name!r} missing in other dataset")
            cols[name] = list(self.columns[name]) + list(other.columns[name])
        return SequenceDataset(self.sequences + other.sequences, cols)


def split_dataset(ds: SequenceDataset,
                  train_split: float = 0.8,
                  val_split: float = 0.1,
                  test_split: float = 0.1,
                  shuffle: bool = True,
                  seed: int = 12) -> tuple:
    """Fractional shuffle-split (reference split_dataset,
    dataloader_utils.py:272-303; same default seed 12)."""
    if abs((train_split + val_split + test_split) - 1.0) > 1e-9:
        raise ValueError(
            "The dataset can only be split in parts that sum up to 1 or a "
            "100%.")
    n = len(ds)
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    n_train = int(train_split * n)
    n_val = int(val_split * n)
    return (ds.select(order[:n_train]),
            ds.select(order[n_train:n_train + n_val]),
            ds.select(order[n_train + n_val:]))
