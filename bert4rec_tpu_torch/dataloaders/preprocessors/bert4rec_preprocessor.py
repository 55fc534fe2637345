"""BERT4Rec feature preprocessor (port of
``bert4rec_tpu/dataloaders/preprocessors/bert4rec_preprocessor.py``).

Training: ``process_dataset`` tokenizes every sequence once and returns a
:class:`ProcessedDataset` whose truncation, masking and padding run
vectorized per epoch. Inference: tokenize -> trim to ``max_seq_len - 1``
-> append ``[UNK]`` -> tail window -> last-token mask -> pad, giving
features byte-identical to the JAX package's (the last-token rows draw no
random numbers, so ``dataloader_utils.inference_features`` computes them
without a ``ProcessedDataset``).
"""

from typing import List, Optional

import numpy as np

from bert4rec_tpu_torch.dataloaders import dataloader_utils as utils
from bert4rec_tpu_torch.dataloaders.preprocessors.base_preprocessor import (
    BasePreprocessor,
)
from bert4rec_tpu_torch.dataloaders.processed_dataset import (
    MaskingConfig, ProcessedDataset,
)
from bert4rec_tpu_torch.dataloaders.sequence_dataset import SequenceDataset


class BERT4RecPreprocessor(BasePreprocessor):

    # which ProcessedDataset task the produced datasets run ("mlm" here;
    # the SASRec preprocessor overrides with "next_item")
    _TASK = "mlm"

    def __init__(self, **kwargs):
        self.tokenizer = None
        self.max_seq_len: Optional[int] = None
        self.max_predictions_per_seq: Optional[int] = None
        self.mask_token_id: Optional[int] = None
        self.unk_token_id: Optional[int] = None
        self.pad_token_id: Optional[int] = None
        self.masked_lm_rate: Optional[float] = None
        self.mask_token_rate: Optional[float] = None
        self.random_token_rate: Optional[float] = None
        self.set_properties(**kwargs)

    def set_properties(self,
                       tokenizer=None,
                       max_seq_len: int = None,
                       max_predictions_per_seq: int = None,
                       mask_token_id: int = None,
                       unk_token_id: int = None,
                       pad_token_id: int = None,
                       masked_lm_rate: float = None,
                       mask_token_rate: float = None,
                       random_token_rate: float = None):
        """Only overwrite attributes that are explicitly given (reference
        set_properties semantics, bert4rec_preprocessor.py:34-45)."""
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
        if masked_lm_rate is not None:
            self.masked_lm_rate = masked_lm_rate
        if mask_token_rate is not None:
            self.mask_token_rate = mask_token_rate
        if random_token_rate is not None:
            self.random_token_rate = random_token_rate

    # ------------------------------------------------------------------ #

    def _masking_config(self) -> MaskingConfig:
        return MaskingConfig(
            max_seq_len=self.max_seq_len,
            max_predictions_per_seq=self.max_predictions_per_seq,
            mask_token_id=self.mask_token_id,
            pad_token_id=self.pad_token_id,
            unk_token_id=self.unk_token_id,
            masked_lm_rate=self.masked_lm_rate,
            mask_token_rate=self.mask_token_rate,
            random_token_rate=self.random_token_rate,
        )

    def _tokenize_sequences(self, ds) -> List[np.ndarray]:
        """Tokenize every sequence in ONE vectorized pass: the string
        sequences are flattened, tokenized together (unique-then-map in
        the tokenizer), and split back — per-element python tokenize
        calls dominated ML-20M-scale prep before (~140M calls)."""
        seqs = list(ds)
        out: List = [None] * len(seqs)
        to_tok, idxs = [], []
        # input duplication (SequenceDataset.repeat) shares the underlying
        # sequence objects — tokenize each distinct object once
        first_seen: dict = {}
        dup_of = []
        for i, seq in enumerate(seqs):
            if isinstance(seq, np.ndarray) and np.issubdtype(
                    seq.dtype, np.integer):
                out[i] = seq.astype(np.int32)
            elif id(seq) in first_seen:
                dup_of.append((i, first_seen[id(seq)]))
            else:
                first_seen[id(seq)] = i
                to_tok.append(np.asarray(list(seq), dtype=object))
                idxs.append(i)
        if to_tok:
            flat = np.concatenate(to_tok)
            ids = np.asarray(self.tokenizer.tokenize(flat), dtype=np.int32)
            offsets = np.cumsum([len(a) for a in to_tok])[:-1]
            for i, part in zip(idxs, np.split(ids, offsets)):
                out[i] = part
        for i, src in dup_of:
            out[i] = out[src]
        return out

    def process_dataset(self, ds, apply_mlm: bool, finetuning: bool) -> ProcessedDataset:
        """Tokenize once; masking/truncation/padding happen per epoch,
        vectorized (no tf.numpy_function bridge needed)."""
        sequences = self._tokenize_sequences(ds)
        timestamps = None
        if isinstance(ds, SequenceDataset) and "timestamps" in ds.columns:
            timestamps = ds.columns["timestamps"]
        return ProcessedDataset(
            sequences, self._masking_config(),
            vocab_size_fn=self.tokenizer.get_vocab_size,
            apply_mlm=apply_mlm,
            finetuning=np.full(len(sequences), bool(finetuning)),
            timestamps=timestamps, task=self._TASK)

    def process_element(self, sequence, apply_mlm: bool, finetuning: bool,
                        seed: Optional[int] = None) -> dict:
        """Single-element parity API (reference process_element, :48-116).

        Returns unbatched ``[S]`` / ``[P]`` int32 features.
        """
        tokens = np.asarray(self.tokenizer.tokenize(list(sequence)),
                            dtype=np.int32)
        ds = ProcessedDataset(
            [tokens], self._masking_config(),
            vocab_size_fn=self.tokenizer.get_vocab_size,
            apply_mlm=apply_mlm,
            finetuning=np.array([finetuning]), task=self._TASK)
        features = ds.materialize(seed)
        return {k: v[0] for k, v in features.items()}

    def prepare_inference(self, data) -> dict:
        """One history -> ``[1, ...]`` features."""
        if not isinstance(data, list):
            raise ValueError(
                "To prepare data for inference, please simply put in an "
                "unprocessed sequence of data (i.e. a list of strings).")
        return self.prepare_inference_batch([data])

    def _inference_tokens(self, sequences) -> list:
        """Each history trimmed to ``max_seq_len - 1`` with ``[UNK]``
        appended as the prediction placeholder, tokenized."""
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
        return tokens

    def prepare_inference_batch(self, sequences) -> dict:
        """Many histories at once (the serving hot path)."""
        return utils.inference_features(
            self._inference_tokens(sequences), self.max_seq_len,
            self.max_predictions_per_seq, self.pad_token_id,
            self.mask_token_id)
