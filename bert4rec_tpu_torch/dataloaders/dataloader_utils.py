"""Dataloader machinery: sequence building, LOO split, vectorized masking,
batching, and the inference features (port of
``bert4rec_tpu/dataloaders/dataloader_utils.py``).

The per-element python masking loop of the reference becomes one batched
numpy pass; the leave-one-out split becomes a pandas groupby without the
per-user python loop. The causal next-item features wait for the SASRec
slice of the port.
"""

import collections
from typing import List, Optional, Sequence

import numpy as np
import pandas as pd

from bert4rec_tpu_torch.dataloaders.sequence_dataset import SequenceDataset, split_dataset  # noqa: F401 (re-export)


# --------------------------------------------------------------------------- #
# popularity & sequence construction
# --------------------------------------------------------------------------- #

def rank_items_by_popularity(items: list) -> list:
    """Items sorted by frequency desc, duplicates removed, first-seen stable
    (reference dataloader_utils.py:14-18)."""
    counts = collections.Counter(items)
    sorted_items = sorted(items, key=counts.get, reverse=True)
    return list(dict.fromkeys(sorted_items))


def group_sequences(df: pd.DataFrame, group_column_name: str,
                    extract_columns: list) -> dict:
    """Per-group value sequences, vectorized.

    Semantics are identical to ``groupby(sort=True)[col].agg(list)`` —
    groups ordered by key, rows keeping their df order within a group —
    but via factorize + stable argsort + split (C speed) instead of
    pandas' pure-python list aggregation, which dominated ML-20M-scale
    data prep (~70 s of a 210 s ``prepare_training``).

    :returns: ``{col: [np.ndarray per group, ...]}``
    """
    if len(df) == 0:
        return {c: [] for c in extract_columns}
    codes, _ = pd.factorize(df[group_column_name], sort=True)
    keep = np.flatnonzero(codes >= 0)  # groupby drops NaN keys; so do we
    if keep.size == 0:
        return {c: [] for c in extract_columns}
    order = keep[np.argsort(codes[keep], kind="stable")]
    boundaries = np.cumsum(np.bincount(codes[keep]))[:-1]
    return {c: np.split(df[c].to_numpy()[order], boundaries)
            for c in extract_columns}


def make_sequence_df(df: pd.DataFrame,
                     group_column_name: str,
                     extract_sequences: list,
                     min_sequence_length: int = 0) -> pd.DataFrame:
    """Group ``df`` rows into per-group sequence lists (reference :82-110).

    Groups whose first extracted column is shorter than ``min_sequence_length``
    are dropped entirely.
    """
    data = group_sequences(df, group_column_name, extract_sequences)
    seq_df = pd.DataFrame(data).reset_index(drop=True)
    if min_sequence_length > 0:
        keep = seq_df[extract_sequences[0]].map(len) >= min_sequence_length
        seq_df = seq_df[keep].reset_index(drop=True)
    return seq_df


def split_sequence_df(df: pd.DataFrame,
                      group_by_column: str,
                      extract_columns: list,
                      min_sequence_length: int = 5) -> tuple:
    """Leave-one-out split (reference :113-174).

    train = seq[:-2], val = seq[:-1], test = full sequence. Sequences shorter
    than ``min_sequence_length`` go to train (whole) only and are omitted from
    val/test — same protocol as the reference (quirk documented in
    SURVEY.md §7).
    """
    if group_by_column not in df.columns:
        raise ValueError(
            f"Group column key {group_by_column} is not present in columns "
            f"in dataframe: {df.columns}")
    for col in extract_columns:
        if col not in df.columns:
            raise ValueError(
                f"Column key {col} of the extract_columns argument is not "
                f"present in columns in dataframe: {df.columns}")

    cols = group_sequences(df, group_by_column, extract_columns)
    long_enough = [len(s) >= min_sequence_length
                   for s in cols[extract_columns[0]]]

    train, val, test = {}, {}, {}
    for c in extract_columns:
        full = cols[c]
        train[c] = [s[:-2] if ok else s for s, ok in zip(full, long_enough)]
        val[c] = [s[:-1] for s, ok in zip(full, long_enough) if ok]
        test[c] = [s for s, ok in zip(full, long_enough) if ok]

    train_df = pd.DataFrame(train).reset_index(drop=True)
    val_df = pd.DataFrame(val).reset_index(drop=True)
    test_df = pd.DataFrame(test).reset_index(drop=True)
    return train_df, val_df, test_df


def sequence_df_to_dataset(df: pd.DataFrame, main_column: str,
                           extra_columns: Sequence[str] = ()) -> SequenceDataset:
    """Convert a sequence DataFrame into a :class:`SequenceDataset`."""
    return SequenceDataset(
        df[main_column].tolist(),
        {c: df[c].tolist() for c in extra_columns})


def duplicate_dataset(ds: SequenceDataset, duplication_factor: int) -> SequenceDataset:
    """reference :177-183"""
    return ds.repeat(duplication_factor)


# --------------------------------------------------------------------------- #
# padding / ragged -> dense
# --------------------------------------------------------------------------- #

def pad_sequences(sequences: List[np.ndarray],
                  max_len: int,
                  pad_id: int = 0,
                  dtype=np.int32) -> tuple:
    """Stack ragged sequences into ``[N, max_len]`` plus an int32 length
    vector.

    Sequences longer than ``max_len`` must be truncated beforehand
    (see :func:`truncate_sequences`).
    """
    n = len(sequences)
    lengths = np.fromiter((len(s) for s in sequences), count=n, dtype=np.int32)
    if lengths.size and lengths.max() > max_len:
        raise ValueError(
            f"pad_sequences got a sequence of length {lengths.max()} > "
            f"max_len={max_len}; truncate first.")
    out = np.full((n, max_len), pad_id, dtype=dtype)
    for i, s in enumerate(sequences):
        out[i, : lengths[i]] = s
    return out, lengths


def truncate_sequences(sequences: List[np.ndarray],
                       max_len: int,
                       rng: np.random.Generator,
                       tail_window: bool = False) -> List[np.ndarray]:
    """Crop over-long sequences (reference bert4rec_preprocessor.py:59-67).

    Training uses a random window; finetuning/val/test/inference take the most
    recent ``max_len`` items (``tail_window=True``).
    """
    out = []
    for s in sequences:
        s = np.asarray(s)
        if len(s) <= max_len:
            out.append(s)
        elif tail_window:
            out.append(s[-max_len:])
        else:
            start = int(rng.integers(0, len(s) - max_len + 1))
            out.append(s[start:start + max_len])
    return out


# --------------------------------------------------------------------------- #
# dynamic MLM masking — vectorized
# --------------------------------------------------------------------------- #

def apply_dynamic_masking_batch(input_ids: np.ndarray,
                                lengths: np.ndarray,
                                max_selections_per_seq: int,
                                mask_token_id: int,
                                special_token_ids: Sequence[int],
                                vocab_size: int,
                                rng: np.random.Generator,
                                selection_rate: float = 0.2,
                                mask_token_rate: float = 0.8,
                                random_token_rate: float = 0.1,
                                finetuning: Optional[np.ndarray] = None) -> dict:
    """BERT-style dynamic masking over a whole padded batch at once.

    Reproduces the per-sequence math of the reference
    ``apply_dynamic_masking_task`` (dataloader_utils.py:186-261):

    - ``num_to_predict = min(max_sel, max(1, int(len * selection_rate)))``
    - positions drawn uniformly without replacement among non-special tokens,
      then sorted ascending;
    - per selected position, one uniform draw ``rn``:
      ``rn < mask_rate`` -> [MASK]; ``mask_rate <= rn < mask_rate+random_rate``
      -> random non-special token; else keep the original token
      (equivalent to the reference's override order at :249-255);
    - ``masked_lm_{ids,positions,weights}`` padded to ``max_selections_per_seq``
      with the pad id 0 (reference bert4rec_preprocessor.py:95-99).

    Rows flagged in ``finetuning`` get last-token-only masking instead
    (reference ``mask_last_token_only``, dataloader_utils.py:264-269).

    :param input_ids: ``[N, S]`` padded int array (pad id must be a special id)
    :param lengths: ``[N]`` true sequence lengths
    :returns: feature dict with ``input_word_ids`` (masked), ``masked_lm_ids``,
        ``masked_lm_positions``, ``masked_lm_weights`` — all ``[N, P]`` or
        ``[N, S]`` int32.
    """
    n, s = input_ids.shape
    p = max_selections_per_seq
    lengths = np.asarray(lengths, dtype=np.int32)
    pos = np.arange(s, dtype=np.int32)[None, :]

    # candidate positions: inside the sequence and not a special token
    valid = pos < lengths[:, None]
    if len(special_token_ids):
        valid &= ~np.isin(input_ids, np.asarray(special_token_ids))
    n_valid = valid.sum(axis=1)

    num_to_predict = np.minimum(
        p, np.maximum(1, (n_valid * selection_rate).astype(np.int64))
    ).astype(np.int32)
    # degenerate all-special rows predict nothing
    num_to_predict = np.where(n_valid == 0, 0, num_to_predict)

    # uniform shuffle of candidate positions per row: rank random keys
    keys = rng.random((n, s))
    keys[~valid] = np.inf
    order = np.argsort(keys, axis=1, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(s)[None, :].repeat(n, 0), axis=1)
    selected = rank < num_to_predict[:, None]

    if finetuning is not None and finetuning.any():
        # last-token-only rows: select exactly the final valid position
        last = np.maximum(lengths - 1, 0)
        ft_sel = pos == last[:, None]
        selected = np.where(finetuning[:, None], ft_sel, selected)
        num_to_predict = np.where(finetuning, (lengths > 0).astype(np.int32),
                                  num_to_predict)

    # replacement draw per position
    rn = rng.random((n, s))
    if finetuning is not None and finetuning.any():
        rn = np.where(finetuning[:, None], 0.0, rn)  # finetuning always masks

    selectable = _selectable_vocab(vocab_size, special_token_ids)
    random_tokens = selectable[rng.integers(0, len(selectable), size=(n, s))]

    replaced = np.where(rn < mask_token_rate + random_token_rate,
                        random_tokens, input_ids)
    replaced = np.where(rn < mask_token_rate, mask_token_id, replaced)
    masked_input = np.where(selected, replaced, input_ids).astype(np.int32)

    # scatter selected (ascending) positions/ids into [N, P] slots
    slot = np.cumsum(selected, axis=1) - 1
    rows, cols = np.nonzero(selected)
    slots = slot[rows, cols]
    keep = slots < p  # finetuning override can't exceed p=|1|, but be safe
    rows, cols, slots = rows[keep], cols[keep], slots[keep]

    masked_lm_positions = np.zeros((n, p), dtype=np.int32)
    masked_lm_ids = np.zeros((n, p), dtype=np.int32)
    masked_lm_weights = np.zeros((n, p), dtype=np.int32)
    masked_lm_positions[rows, slots] = cols
    masked_lm_ids[rows, slots] = input_ids[rows, cols]
    masked_lm_weights[rows, slots] = 1

    return {
        "input_word_ids": masked_input,
        "masked_lm_positions": masked_lm_positions,
        "masked_lm_ids": masked_lm_ids,
        "masked_lm_weights": masked_lm_weights,
    }


def _selectable_vocab(vocab_size: int, special_token_ids: Sequence[int]) -> np.ndarray:
    ids = np.arange(vocab_size, dtype=np.int32)
    if len(special_token_ids):
        ids = ids[~np.isin(ids, np.asarray(special_token_ids))]
    return ids


def apply_dynamic_masking_task(sequence: np.ndarray,
                               max_selections_per_seq: int,
                               mask_token_id: int,
                               special_token_ids: Sequence[int],
                               vocab_size: int,
                               selection_rate: float = 0.2,
                               mask_token_rate: float = 0.8,
                               random_token_rate: float = 0.1,
                               seed: Optional[int] = None) -> tuple:
    """One sequence through :func:`apply_dynamic_masking_batch` with a
    generator seeded by ``seed``: ``(masked_token_ids, masked_lm_positions,
    masked_lm_ids)``, unpadded, in the sequence's dtype."""
    sequence = np.asarray(sequence)
    rng = np.random.default_rng(seed)
    out = apply_dynamic_masking_batch(
        sequence[None, :].astype(np.int32),
        np.array([len(sequence)], dtype=np.int32),
        max_selections_per_seq, mask_token_id, list(special_token_ids),
        vocab_size, rng, selection_rate, mask_token_rate, random_token_rate)
    w = out["masked_lm_weights"][0].astype(bool)
    return (out["input_word_ids"][0].astype(sequence.dtype),
            out["masked_lm_positions"][0][w].astype(sequence.dtype),
            out["masked_lm_ids"][0][w].astype(sequence.dtype))


def mask_last_token_only(sequence: np.ndarray, mask_token_id: int) -> tuple:
    """``(sequence with its last token masked, [last position], [last
    token])``: the evaluation task on one sequence."""
    sequence = np.asarray(sequence).copy()
    masked_lm_ids = np.array([sequence[-1]], dtype=sequence.dtype)
    masked_lm_positions = np.array([len(sequence) - 1], dtype=sequence.dtype)
    sequence[-1] = mask_token_id
    return sequence, masked_lm_positions, masked_lm_ids


# --------------------------------------------------------------------------- #
# batching
# --------------------------------------------------------------------------- #

def make_batches(features: dict,
                 batch_size: int = 64,
                 shuffle: bool = True,
                 seed: Optional[int] = None,
                 drop_remainder: bool = False,
                 pad_final_batch: bool = False):
    """Yield fixed-shape mini-batch dicts from a dict of ``[N, ...]`` arrays.

    Replaces reference ``make_batches`` (dataloader_utils.py:306-346) without
    its cache-after-shuffle quirk: every epoch call reshuffles. With
    ``pad_final_batch`` the last partial batch is zero-padded to ``batch_size``
    (static shapes for XLA) and carries an extra ``example_weights`` key
    marking real rows.
    """
    n = len(next(iter(features.values())))
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for start in range(0, stop, batch_size):
        idx = order[start:start + batch_size]
        batch = {k: v[idx] for k, v in features.items()}
        if pad_final_batch and len(idx) < batch_size:
            pad = batch_size - len(idx)
            batch = {k: np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)]) for k, v in
                batch.items()}
            batch["example_weights"] = np.concatenate(
                [np.ones(len(idx), np.float32), np.zeros(pad, np.float32)])
        elif pad_final_batch:
            batch["example_weights"] = np.ones(batch_size, np.float32)
        yield batch


# --------------------------------------------------------------------------- #
# causal next-item features (SASRec)
# --------------------------------------------------------------------------- #

def next_item_features(input_ids: np.ndarray,
                       lengths: np.ndarray,
                       max_predictions_per_seq: int,
                       pad_token_id: int,
                       finetuning: Optional[np.ndarray] = None) -> dict:
    """Next-item prediction features over a padded batch, one vectorized
    pass (JAX ``dataloader_utils.next_item_features``, byte for byte).

    The model input drops each row's final item; predictions sit at the
    remaining positions with label = the following item, in the
    ``masked_lm_*`` feature contract. Rows flagged ``finetuning`` predict
    only at the last input position (the leave-one-out protocol); when a
    row has more than ``max_predictions_per_seq`` predictable positions,
    the LAST ones are kept.

    :param input_ids: ``[N, S]`` padded int array (full sequences)
    :param lengths: ``[N]`` true sequence lengths
    :returns: ``input_word_ids`` ``[N, S]`` (final item dropped),
        ``masked_lm_{positions,ids,weights}`` ``[N, P]`` int32
    """
    n, s = input_ids.shape
    p = max_predictions_per_seq
    lengths = np.asarray(lengths, dtype=np.int32)
    rows = np.arange(n)

    inp = np.asarray(input_ids, dtype=np.int32).copy()
    has = lengths >= 1
    inp[rows[has], lengths[has] - 1] = pad_token_id

    if finetuning is None:
        finetuning = np.zeros(n, dtype=bool)
    k_all = np.maximum(lengths - 1, 0)
    k = np.where(finetuning, np.minimum(k_all, 1),
                 np.minimum(k_all, p)).astype(np.int32)
    start = lengths - 1 - k                      # first predicted position
    offs = np.arange(p, dtype=np.int32)[None, :]
    valid = offs < k[:, None]
    positions = np.where(valid, start[:, None] + offs, 0).astype(np.int32)
    label_idx = np.minimum(positions + 1, s - 1)
    ids = np.where(valid, input_ids[rows[:, None], label_idx], 0) \
        .astype(np.int32)
    return {
        "input_word_ids": inp,
        "masked_lm_positions": positions,
        "masked_lm_ids": ids,
        "masked_lm_weights": valid.astype(np.int32),
    }


# --------------------------------------------------------------------------- #
# inference features: the deterministic (finetuning-mode) rows, which both
# masking engines compute identically (no random draws)
# --------------------------------------------------------------------------- #

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
    input_ids, lengths = pad_sequences(
        truncate_sequences(sequences, max_seq_len, rng=None,
                           tail_window=True), max_seq_len, pad_token_id)
    input_mask = (np.arange(max_seq_len)[None, :]
                  < lengths[:, None]).astype(np.int32)
    features = {"labels": input_ids, "input_word_ids": input_ids,
                "input_mask": input_mask}
    features.update(mask_last_token_batch(
        input_ids, lengths, max_predictions_per_seq, mask_token_id))
    return features
