"""BERT4Rec inference preprocessing (port of the inference half of
``bert4rec_tpu/dataloaders/preprocessors/bert4rec_preprocessor.py``):
tokenize -> trim to ``max_seq_len - 1`` -> append ``[UNK]`` -> tail window
-> last-token mask -> pad, giving features byte-identical to the JAX
package's."""

from typing import Optional

import numpy as np

from bert4rec_tpu_torch.dataloaders import dataloader_utils as utils


class BERT4RecPreprocessor:

    def __init__(self, **kwargs):
        self.tokenizer = None
        self.max_seq_len: Optional[int] = None
        self.max_predictions_per_seq: Optional[int] = None
        self.mask_token_id: Optional[int] = None
        self.unk_token_id: Optional[int] = None
        self.pad_token_id: Optional[int] = None
        self.set_properties(**kwargs)

    def set_properties(self, tokenizer=None, max_seq_len: int = None,
                       max_predictions_per_seq: int = None,
                       mask_token_id: int = None, unk_token_id: int = None,
                       pad_token_id: int = None):
        """Only overwrite attributes that are explicitly given."""
        if tokenizer is not None:
            self.tokenizer = tokenizer
        if max_seq_len is not None:
            self.max_seq_len = max_seq_len
        if max_predictions_per_seq is not None:
            self.max_predictions_per_seq = max_predictions_per_seq
        if mask_token_id is not None:
            self.mask_token_id = mask_token_id
        if unk_token_id is not None:
            self.unk_token_id = unk_token_id
        if pad_token_id is not None:
            self.pad_token_id = pad_token_id

    def prepare_inference(self, data) -> dict:
        """One history -> ``[1, ...]`` features."""
        if not isinstance(data, list):
            raise ValueError(
                "To prepare data for inference, please simply put in an "
                "unprocessed sequence of data (i.e. a list of strings).")
        return self.prepare_inference_batch([data])

    def prepare_inference_batch(self, sequences) -> dict:
        """Many histories at once (the serving hot path)."""
        tokens = []
        for data in sequences:
            if not isinstance(data, list):
                raise ValueError(
                    "To prepare data for inference, please simply put in "
                    "an unprocessed sequence of data (i.e. a list of "
                    "strings).")
            seq = list(data[-self.max_seq_len + 1:]) + ["[UNK]"]
            tokens.append(np.asarray(self.tokenizer.tokenize(seq),
                                     dtype=np.int32))
        return utils.inference_features(
            tokens, self.max_seq_len, self.max_predictions_per_seq,
            self.pad_token_id, self.mask_token_id)
