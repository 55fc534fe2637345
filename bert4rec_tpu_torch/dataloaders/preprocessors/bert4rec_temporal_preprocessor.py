"""Temporal BERT4Rec preprocessor (port of
``bert4rec_tpu/dataloaders/preprocessors/bert4rec_temporal_preprocessor.py``):
adds an aligned ``input_timestamps`` feature.

Timestamps are truncated and padded in lockstep with the item sequence by
:class:`ProcessedDataset`; ``prepare_inference`` appends the current
wall-clock time for the ``[UNK]`` placeholder. Serving batches
(``prepare_inference_batch``, inherited) carry no timestamps, as in JAX.
"""

import time
from typing import Optional

import numpy as np

from bert4rec_tpu_torch.dataloaders.preprocessors.bert4rec_preprocessor import (
    BERT4RecPreprocessor,
)
from bert4rec_tpu_torch.dataloaders.processed_dataset import ProcessedDataset
from bert4rec_tpu_torch.dataloaders.sequence_dataset import SequenceDataset


class BERT4RecTemporalPreprocessor(BERT4RecPreprocessor):

    def process_dataset(self, ds, apply_mlm: bool,
                        finetuning: bool) -> ProcessedDataset:
        """Takes the aligned column under the canonical name
        ``timestamps``, or, when the dataloader extracted exactly one extra
        column (``extract_data=[<item>, "timestamp"]``), that column."""
        if isinstance(ds, SequenceDataset) and "timestamps" not in ds.columns \
                and len(ds.columns) == 1:
            only = next(iter(ds.columns))
            ds = SequenceDataset(ds.sequences,
                                 {"timestamps": ds.columns[only]})
        if not (isinstance(ds, SequenceDataset)
                and "timestamps" in ds.columns):
            raise ValueError(
                "The temporal preprocessor needs a SequenceDataset with an "
                "aligned 'timestamps' column.")
        return super().process_dataset(ds, apply_mlm, finetuning)

    def process_element(self, sequence, apply_mlm: bool, finetuning: bool,
                        timestamps=None, seed: Optional[int] = None) -> dict:
        tokens = np.asarray(self.tokenizer.tokenize(list(sequence)),
                            dtype=np.int32)
        if timestamps is None:
            raise ValueError("The temporal preprocessor needs timestamps "
                             "aligned with the sequence.")
        if len(timestamps) != len(tokens):
            raise ValueError(
                f"timestamps (len {len(timestamps)}) must align with the "
                f"sequence (len {len(tokens)})")
        ds = ProcessedDataset(
            [tokens], self._masking_config(),
            vocab_size_fn=self.tokenizer.get_vocab_size,
            apply_mlm=apply_mlm,
            finetuning=np.array([finetuning]),
            timestamps=[np.asarray(timestamps, dtype=np.int64)],
            task=self._TASK)
        features = ds.materialize(seed)
        return {k: v[0] for k, v in features.items()}

    def prepare_inference(self, data, timestamps=None) -> dict:
        if not isinstance(data, list):
            raise ValueError(
                "To prepare data for inference, please simply put in an "
                "unprocessed sequence of data (i.e. a list of strings).")
        sequence = data[-self.max_seq_len + 1:] + ["[UNK]"]
        if timestamps is None:
            timestamps = list(range(len(data)))
        timestamps = list(timestamps)[-self.max_seq_len + 1:]
        # the appended placeholder item happens "now"
        timestamps = timestamps + [round(time.time())]
        features = self.process_element(sequence, apply_mlm=True,
                                        finetuning=True, timestamps=timestamps)
        return {k: v[None, ...] for k, v in features.items()}
