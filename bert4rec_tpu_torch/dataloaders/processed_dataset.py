"""A preprocessed (tokenized) dataset that materializes masked batches.

The reference applies MLM masking inside ``tf.data.Dataset.map`` with a
python escape hatch (bert4rec_preprocessor.py:118-122) and then accidentally
freezes the masks with ``.cache()`` (dataloader_utils.py:341-346).

Here, masking is *re-applied vectorized per epoch* from an explicit seed:
``ProcessedDataset`` holds the tokenized sequences plus preprocessing config
and produces fixed-shape int32 feature batches on demand — deterministic,
reproducible, and cheap enough to overlap with device compute.

Port of ``bert4rec_tpu/dataloaders/processed_dataset.py``, both tasks:
``"mlm"`` (BERT4Rec) and ``"next_item"`` (SASRec). ``shard_for_process``
takes its defaults from ``torch.distributed`` when it is initialised, else
(0, 1).
"""

import dataclasses
import os
from typing import List, Optional

import numpy as np

from bert4rec_tpu_torch.dataloaders import dataloader_utils as utils
from bert4rec_tpu_torch.dataloaders import native


def _use_native() -> bool:
    """Native masking engine on by default when g++ built it; opt out with
    BERT4REC_TPU_NATIVE=0 (same distribution, different random streams)."""
    return (os.environ.get("BERT4REC_TPU_NATIVE", "1") != "0"
            and native.available())


def _distributed_rank_and_size() -> tuple:
    """(rank, world size) of an initialised ``torch.distributed`` group,
    else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass
class MaskingConfig:
    max_seq_len: int
    max_predictions_per_seq: int
    mask_token_id: int
    pad_token_id: int
    unk_token_id: int
    masked_lm_rate: float = 0.2
    mask_token_rate: float = 1.0
    random_token_rate: float = 0.0

    @property
    def special_token_ids(self) -> list:
        return [self.unk_token_id, self.pad_token_id]


class ProcessedDataset:
    """Tokenized sequences + masking config; features materialize per epoch."""

    def __init__(self,
                 sequences: List[np.ndarray],
                 config: MaskingConfig,
                 vocab_size_fn,
                 apply_mlm: bool = True,
                 finetuning: Optional[np.ndarray] = None,
                 timestamps: Optional[List[np.ndarray]] = None,
                 task: str = "mlm"):
        """
        :param vocab_size_fn: zero-arg callable returning the *current* vocab
            size (the tokenizer may still grow while extensible).
        :param finetuning: per-sequence bool array — True rows get last-token-
            only masking + tail truncation (the reference's finetuning mode).
        :param task: ``"mlm"`` (BERT4Rec dynamic masking) or ``"next_item"``
            (SASRec-style causal prediction: the final item is dropped from
            the input and every remaining position predicts its successor —
            finetuning rows predict only the held-out last item). Both emit
            the same feature-dict contract.
        """
        if task not in ("mlm", "next_item"):
            raise ValueError(f"Unknown task {task!r}; "
                             f"expected 'mlm' or 'next_item'")
        self.task = task
        self.sequences = [np.asarray(s, dtype=np.int32) for s in sequences]
        self.config = config
        self.vocab_size_fn = vocab_size_fn
        self.apply_mlm = apply_mlm
        if finetuning is None:
            finetuning = np.zeros(len(self.sequences), dtype=bool)
        elif np.isscalar(finetuning) or isinstance(finetuning, bool):
            finetuning = np.full(len(self.sequences), bool(finetuning))
        self.finetuning = np.asarray(finetuning, dtype=bool)
        self.timestamps = timestamps
        self._build_cache()

    def _build_cache(self):
        """Pad every sequence once at construction time.

        Per-epoch work then reduces to a memcpy + vectorized masking; only
        over-long NON-finetuning rows get a fresh random window each epoch
        (finetuning/eval rows use the deterministic tail window, cached
        here). This is what lets the host pipeline outrun the chip
        (SURVEY.md §7 hard part 4).
        """
        cfg = self.config
        n, s = len(self.sequences), cfg.max_seq_len
        self._cache_ids = np.full((n, s), cfg.pad_token_id, dtype=np.int32)
        self._cache_len = np.zeros(n, dtype=np.int32)
        self._cache_ts = (np.zeros((n, s), dtype=np.int64)
                          if self.timestamps is not None else None)
        long_rows = []
        for i, seq in enumerate(self.sequences):
            ln = len(seq)
            if ln <= s:
                self._cache_ids[i, :ln] = seq
                self._cache_len[i] = ln
                if self._cache_ts is not None:
                    self._cache_ts[i, :ln] = np.asarray(
                        self.timestamps[i])[:ln]
            else:
                self._cache_len[i] = s
                if self.finetuning[i]:
                    self._cache_ids[i] = seq[-s:]  # tail window, fixed
                    if self._cache_ts is not None:
                        self._cache_ts[i] = np.asarray(
                            self.timestamps[i])[-s:]
                else:
                    self._cache_ids[i] = seq[:s]   # refreshed per epoch
                    if self._cache_ts is not None:
                        self._cache_ts[i] = np.asarray(
                            self.timestamps[i])[:s]
                    long_rows.append(i)
        self._long_rows = np.asarray(long_rows, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.sequences)

    def cardinality(self) -> int:
        return len(self.sequences)

    def select(self, indices) -> "ProcessedDataset":
        """A new dataset holding the given rows (shared immutable seqs)."""
        idx = np.asarray(indices)
        ts = ([self.timestamps[i] for i in idx]
              if self.timestamps is not None else None)
        return ProcessedDataset(
            [self.sequences[i] for i in idx], self.config,
            self.vocab_size_fn, self.apply_mlm, self.finetuning[idx], ts,
            task=self.task)

    def shard_for_process(self,
                          process_index: Optional[int] = None,
                          process_count: Optional[int] = None,
                          mesh=None) -> "ProcessedDataset":
        """This process's disjoint slice of the dataset for multi-host runs.

        Every process must call this on the SAME (identically-ordered)
        dataset; rows are strided ``index::count`` and truncated so all
        processes hold exactly ``n // count`` rows — equal step counts per
        epoch keep the collective schedules in lockstep across hosts.

        Defaults come from ``torch.distributed`` (this process's rank and
        the world size) when it is initialised, else (0, 1); the JAX
        package reads ``jax.process_index/process_count``. With a ``mesh``
        (``core.mesh.Mesh``) they are its 'data' coordinate and the 'data'
        axis's size: the ranks of one 'data' coordinate (its 'model'
        ranks) get the same slice.
        """
        pi, pc = process_index, process_count
        if mesh is not None:
            pi = mesh.index("data") if pi is None else pi
            pc = mesh.size("data") if pc is None else pc
        if pi is None or pc is None:
            rank, world = _distributed_rank_and_size()
            pi = rank if pi is None else pi
            pc = world if pc is None else pc
        if not 0 <= pi < pc:
            raise ValueError(f"process_index {pi} outside [0, {pc})")
        usable = (len(self.sequences) // pc) * pc
        return self.select(np.arange(pi, usable, pc))

    def concatenate(self, other: "ProcessedDataset") -> "ProcessedDataset":
        ts = None
        if self.timestamps is not None and other.timestamps is not None:
            ts = list(self.timestamps) + list(other.timestamps)
        return ProcessedDataset(
            self.sequences + other.sequences, self.config, self.vocab_size_fn,
            self.apply_mlm,
            np.concatenate([self.finetuning, other.finetuning]), ts,
            task=self.task)

    # ------------------------------------------------------------------ #

    def materialize(self, seed: Optional[int] = None,
                    indices: Optional[np.ndarray] = None) -> dict:
        """Produce a feature dict for all rows (or just ``indices``) with
        fresh masks from ``seed``. Pure: never mutates shared state — the
        per-epoch random crop windows of over-long rows are drawn into the
        local output arrays, so concurrent callers and datasets sharing
        sequences never observe each other's crops.

        Emits the reference's exact feature contract
        (bert4rec_preprocessor.py:101-114): ``labels``, ``input_word_ids``,
        ``input_mask`` [N, S] and, with mlm, ``masked_lm_ids``,
        ``masked_lm_positions``, ``masked_lm_weights`` [N, P]; plus
        ``input_timestamps`` when the temporal column is attached.
        """
        cfg = self.config
        rng = np.random.default_rng(seed)

        if indices is None:
            sel = np.arange(len(self.sequences))
            input_ids = self._cache_ids.copy()
            lengths = self._cache_len
            ft = self.finetuning
            ts_pad = (self._cache_ts.copy()
                      if self._cache_ts is not None else None)
        else:
            sel = np.asarray(indices)
            input_ids = self._cache_ids[sel]
            lengths = self._cache_len[sel]
            ft = self.finetuning[sel]
            ts_pad = (self._cache_ts[sel]
                      if self._cache_ts is not None else None)

        # fresh random crop window for the selected over-long training rows
        # (reference bert4rec_preprocessor.py:59-67; aligned w/ timestamps),
        # written into the LOCAL arrays only
        if self._long_rows.size:
            local = np.nonzero(np.isin(sel, self._long_rows))[0]
            for j in local:
                seq = self.sequences[sel[j]]
                start = int(rng.integers(0, len(seq) - cfg.max_seq_len + 1))
                input_ids[j] = seq[start:start + cfg.max_seq_len]
                if ts_pad is not None:
                    ts_pad[j] = np.asarray(
                        self.timestamps[sel[j]])[start:start + cfg.max_seq_len]
        input_mask = (np.arange(cfg.max_seq_len)[None, :]
                      < lengths[:, None]).astype(np.int32)

        # input_ids is already a private copy (cache .copy()/fancy index) and
        # masking produces a new array, so labels can alias it safely
        features = {
            "labels": input_ids,
            "input_word_ids": input_ids,
            "input_mask": input_mask,
        }

        if self.apply_mlm and self.task == "next_item":
            features.update(utils.next_item_features(
                input_ids, lengths, cfg.max_predictions_per_seq,
                cfg.pad_token_id, finetuning=ft))
            # the final item left the input: the mask shrinks with it
            features["input_mask"] = (
                np.arange(cfg.max_seq_len)[None, :]
                < np.maximum(lengths - 1, 0)[:, None]).astype(np.int32)
        elif self.apply_mlm:
            if _use_native():
                int_seed = (int(seed) if seed is not None
                            else int(rng.integers(0, 2 ** 63)))
                masked = native.apply_dynamic_masking_batch_native(
                    input_ids, lengths,
                    cfg.max_predictions_per_seq, cfg.mask_token_id,
                    cfg.special_token_ids, self.vocab_size_fn(), int_seed,
                    selection_rate=cfg.masked_lm_rate,
                    mask_token_rate=cfg.mask_token_rate,
                    random_token_rate=cfg.random_token_rate,
                    finetuning=ft)
            else:
                masked = utils.apply_dynamic_masking_batch(
                    input_ids, lengths,
                    cfg.max_predictions_per_seq, cfg.mask_token_id,
                    cfg.special_token_ids, self.vocab_size_fn(), rng,
                    selection_rate=cfg.masked_lm_rate,
                    mask_token_rate=cfg.mask_token_rate,
                    random_token_rate=cfg.random_token_rate,
                    finetuning=ft)
            features.update(masked)

        if ts_pad is not None:
            features["input_timestamps"] = ts_pad

        return features

    # chunked streaming: bound host memory to O(chunk) instead of O(epoch)
    # (SURVEY.md §7 hard part 4 — ML-20M×dup scale epochs are multi-GB when
    # materialized whole)
    DEFAULT_CHUNK_BATCHES = 64

    def batches(self,
                batch_size: int,
                shuffle: bool = True,
                seed: Optional[int] = None,
                drop_remainder: bool = False,
                pad_final_batch: bool = False,
                chunk_size: Optional[int] = None):
        """Yield fixed-shape feature batches, re-masking this epoch.

        The epoch is masked in chunks of ``chunk_size`` rows (default
        ``64 * batch_size``): the global shuffle happens on indices first,
        then each chunk is materialized (pure) and sliced sequentially —
        identical distribution to whole-epoch materialization with host
        memory bounded by the chunk size.
        """
        n = len(self.sequences)
        if chunk_size is None:
            chunk_size = self.DEFAULT_CHUNK_BATCHES * batch_size
        # chunks must be batch-aligned so only the epoch's final batch can
        # be partial
        chunk_size = max((chunk_size // batch_size) * batch_size, batch_size)

        if chunk_size >= n:
            features = self.materialize(seed)
            yield from utils.make_batches(
                features, batch_size, shuffle=shuffle, seed=seed,
                drop_remainder=drop_remainder,
                pad_final_batch=pad_final_batch)
            return

        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, n, chunk_size):
            idx = order[start:start + chunk_size]
            # a distinct masking stream per (epoch seed, chunk)
            chunk_seed = (None if seed is None else
                          int(np.random.default_rng(
                              [int(seed), start]).integers(0, 2 ** 31)))
            features = self.materialize(chunk_seed, indices=idx)
            last = start + chunk_size >= n
            yield from utils.make_batches(
                features, batch_size, shuffle=False,
                drop_remainder=drop_remainder and last,
                pad_final_batch=pad_final_batch)
