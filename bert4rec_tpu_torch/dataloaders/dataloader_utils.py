"""Inference feature helpers (port of the deterministic parts of
``bert4rec_tpu/dataloaders/dataloader_utils.py`` and
``processed_dataset.py``): tail-window padding and the finetuning-mode
last-token mask, which both of the JAX package's masking engines compute
identically (no random draws)."""

from typing import List

import numpy as np


def pad_tail_windows(sequences: List[np.ndarray], max_seq_len: int,
                     pad_token_id: int) -> tuple:
    """``[N, S]`` int32 ids (each sequence's last ``max_seq_len`` tokens,
    right-padded with ``pad_token_id``) and ``[N]`` int32 lengths — the
    finetuning rows of ``ProcessedDataset._build_cache``."""
    n = len(sequences)
    ids = np.full((n, max_seq_len), pad_token_id, dtype=np.int32)
    lengths = np.zeros(n, dtype=np.int32)
    for i, seq in enumerate(sequences):
        seq = np.asarray(seq, dtype=np.int32)[-max_seq_len:]
        ids[i, :len(seq)] = seq
        lengths[i] = len(seq)
    return ids, lengths


def mask_last_token_batch(input_ids: np.ndarray, lengths: np.ndarray,
                          max_predictions_per_seq: int,
                          mask_token_id: int) -> dict:
    """Last-token-only MLM features for every row (the ``finetuning=True``
    branch of ``apply_dynamic_masking_batch``): the final real token is
    replaced by ``[MASK]`` and becomes prediction slot 0; the other slots
    are 0-padded. Rows of length 0 predict nothing."""
    n = input_ids.shape[0]
    p = max_predictions_per_seq
    masked = input_ids.copy()
    positions = np.zeros((n, p), dtype=np.int32)
    ids = np.zeros((n, p), dtype=np.int32)
    weights = np.zeros((n, p), dtype=np.int32)
    rows = np.nonzero(lengths > 0)[0]
    last = lengths[rows] - 1
    positions[rows, 0] = last
    ids[rows, 0] = input_ids[rows, last]
    weights[rows, 0] = 1
    masked[rows, last] = mask_token_id
    return {
        "input_word_ids": masked,
        "masked_lm_positions": positions,
        "masked_lm_ids": ids,
        "masked_lm_weights": weights,
    }


def inference_features(sequences: List[np.ndarray], max_seq_len: int,
                       max_predictions_per_seq: int, pad_token_id: int,
                       mask_token_id: int) -> dict:
    """The feature dict ``ProcessedDataset.materialize`` emits for
    finetuning rows: ``labels`` (unmasked ids), ``input_word_ids``,
    ``input_mask`` ``[N, S]`` and ``masked_lm_{ids,positions,weights}``
    ``[N, P]``, all int32."""
    input_ids, lengths = pad_tail_windows(sequences, max_seq_len,
                                          pad_token_id)
    input_mask = (np.arange(max_seq_len)[None, :]
                  < lengths[:, None]).astype(np.int32)
    features = {"labels": input_ids, "input_word_ids": input_ids,
                "input_mask": input_mask}
    features.update(mask_last_token_batch(
        input_ids, lengths, max_predictions_per_seq, mask_token_id))
    return features
