"""Sampled-negative and full-catalog ranking evaluator (port of
``bert4rec_tpu/evaluation/bert4rec_evaluator.py``).

The reference protocol (``bert4rec/evaluation/bert4rec_evaluator.py``):
default metrics ``[Counter("Valid Ranks"), NDCG@1/5/10, HR@1/5/10, MAP]``;
default sampler "pop_random" with ``sample_size=100``, its source and vocab
built from the dataloader; per masked position the exclusion set is the
sequence's labels + the ground truth, 100 negatives are drawn and the
ground truth appended => 101 candidates; a metric reads the 1-based rank of
the ground truth. Ties rank ahead of the ground truth.

Three paths, as in the JAX package:
- host negatives (``device_negatives=False``): the numpy sampler draws
  every position's negatives of a batch at once (the same draws as the
  JAX package for one seed), the card scores only the candidates
  (``model.score_candidates``);
- device negatives (the default when the sampler has a popularity
  distribution over integer ids): Gumbel top-k on the card
  (``ops/negative_sampling.py``) from a ``torch.Generator`` seeded per
  batch with ``fold_in(seed, batch index)``; the same distribution as the
  host path, another stream;
- ``full_ranking=True``: each ground truth against the whole catalog
  (``model.gt_ranks_full_vocab``), the same exclusions, no sampler.

Batches are masked on a host thread ahead of use (``utils.prefetch``) and
the ranks are fetched from the card on ``fetch_workers`` threads, so the
loop only prepares and launches.

On a ``(data, model)`` mesh (``core/mesh.py``, one process per rank) each
rank scores its 'data' slice of every batch (its dataset is its slice,
``shard_for_process(mesh=...)``; the final batch is zero-padded so every
rank runs the same batches) with its pieces of the params, the model's
sharded scoring and ranking taking the ``mesh``, and the ``[B, P]`` ranks
of every 'data' coordinate are put together on every rank before the
metrics read them: every rank reports the global metrics. Device
negatives draw from one seed on every rank (rank 0's when the evaluator
has none), with the 'data' coordinate folded in when that axis has
several.
"""

import warnings
from typing import List, Optional

import numpy as np
import torch

from bert4rec_tpu_torch.core import mesh as mesh_lib
from bert4rec_tpu_torch.core import partitioning
from bert4rec_tpu_torch.core.mesh import DATA_AXIS
from bert4rec_tpu_torch.dataloaders.processed_dataset import (
    _distributed_rank_and_size,
)
from bert4rec_tpu_torch.evaluation import evaluation_metrics as metrics_lib
from bert4rec_tpu_torch.evaluation.base_evaluator import BaseEvaluator
from bert4rec_tpu_torch.ops import negative_sampling as ns
from bert4rec_tpu_torch.ops.dropout_bits import fold_in
from bert4rec_tpu_torch.utils import checkpoint as ckpt_lib
from bert4rec_tpu_torch.utils.prefetch import fetch_pipelined, prefetch

_NOT_FEATURES = ("labels", "example_weights")


def default_metrics() -> List[metrics_lib.EvaluationMetric]:
    return [
        metrics_lib.Counter("Valid Ranks"),
        metrics_lib.NDCG(1), metrics_lib.NDCG(5), metrics_lib.NDCG(10),
        metrics_lib.HR(1), metrics_lib.HR(5), metrics_lib.HR(10),
        metrics_lib.MAP(),
    ]


def _model_device(model, params) -> torch.device:
    """The device a batch is scored on: the params' device, or, for a
    scorer without params (``params=None``: the popularity floor, the
    oracles), its ``device``. Never a CPU fallback."""
    if params is not None:
        return next(iter(ckpt_lib.flatten(params).values())).device
    device = getattr(model, "device", None)
    if device is None:
        raise ValueError(
            f"cannot place the batches: params is None and "
            f"{type(model).__name__} has no `device`; pass the model's "
            f"params, or give the scorer a device")
    return torch.device(device)


def _fetch(ranks) -> np.ndarray:
    """A launched batch's ranks on the host (waits for the card)."""
    if torch.is_tensor(ranks):
        return ranks.cpu().numpy()
    return np.asarray(ranks)


class BERT4RecEvaluator(BaseEvaluator):

    def __init__(self, metrics: Optional[list] = None,
                 sampler="pop_random",
                 dataloader=None,
                 sample_size: int = 100,
                 seed: Optional[int] = None,
                 mesh=None,
                 device_negatives: Optional[bool] = None,
                 static_shapes: Optional[bool] = None,
                 full_ranking: bool = False,
                 fetch_workers: int = 2):
        """``seed`` fixes the negatives (host draws and device streams);
        without it every ``evaluate`` draws fresh ones.

        ``device_negatives``: draw the popularity-weighted negatives on the
        card. Default (None): on when the sampler exposes a popularity
        distribution over an integer-id vocab; an explicit True that the
        sampler cannot honour raises. False keeps the host path.

        ``static_shapes``: data-independent shapes (no P-slicing). Default:
        on when ``torch.distributed`` runs more than one process without a
        mesh; a mesh's ranks agree on each batch's width instead.

        ``full_ranking``: rank against the whole catalog instead of 100
        sampled negatives (the unbiased protocol); no sampler is built.

        ``fetch_workers``: threads that fetch the ranks from the card; 0
        fetches each batch before launching the next.

        ``mesh``: this rank's ``core.mesh.Mesh``: batches are its 'data'
        slice, scored data-parallel, the params its pieces (anything but a
        port mesh raises a TypeError)."""
        self.mesh = mesh_lib.as_mesh(mesh, "BERT4RecEvaluator")
        sampler_config = {"sample_size": sample_size}
        if seed is not None:
            sampler_config["seed"] = seed
        super().__init__(metrics if metrics is not None else default_metrics(),
                         None if full_ranking else sampler,
                         dataloader, sampler_config)
        self.full_ranking = full_ranking
        self.fetch_workers = max(0, int(fetch_workers))
        self.sample_size = sample_size
        self.seed = seed
        self.device_negatives = device_negatives
        self.static_shapes = static_shapes
        self._device_consts = None   # (probs, device, logp, vocab_ids)
        self._batch_counter = 0
        self._base_seed = None

    # ------------------------------------------------------------------ #

    def _prepare_sampler(self):
        """Build the sampler's source and vocab from the dataloader
        (reference bert4rec_evaluator.py:26-44)."""
        if self.sampler is None:  # full-ranking protocol: sampler-free
            return
        if self.sampler.is_fully_prepared():
            return
        if self.dataloader is None:
            raise ValueError(
                "The sampler is not fully prepared (missing source/vocab) "
                "and no dataloader is available to derive them from.")
        source = self.dataloader.create_item_list_tokenized()
        self.sampler.set_source(list(source))
        self.sampler.set_vocab(list(dict.fromkeys(source)))
        if self.sampler.sample_size is None:
            self.sampler.set_sample_size(self.sample_size)

    @property
    def _static_shapes(self) -> bool:
        if self.static_shapes is not None:
            return self.static_shapes
        # a mesh agrees on each batch's shapes instead (_agreed_width)
        return self.mesh is None and _distributed_rank_and_size()[1] > 1

    def _agreed_width(self, p_used: int) -> int:
        """The P-slice width every rank of the mesh scores: the widest of
        the 'data' slices' (their ranks are put together)."""
        if self.mesh is None:
            return p_used
        return int(mesh_lib.all_reduce(
            self.mesh, torch.tensor([p_used], device=self.mesh.device),
            DATA_AXIS, "max")[0])

    def _place(self, batch: dict, device, **extra) -> dict:
        """The feature arrays of ``batch`` (and ``extra``) on ``device``
        (on a mesh: this rank's 'data' slice, checked by ``place_batch``)."""
        arrays = {k: v for k, v in batch.items() if k not in _NOT_FEATURES}
        arrays.update(extra)
        if self.mesh is not None:
            partitioning.check_batch(self.mesh, arrays,
                                     what="evaluation batch")
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in arrays.items()}

    # ------------------------------------------------------------------ #
    # device-side negative sampling
    # ------------------------------------------------------------------ #

    def _device_sampling_available(self) -> bool:
        if self.device_negatives is False:
            return False
        s = self.sampler
        ok = (getattr(s, "_probs", None) is not None
              and callable(getattr(s, "_int_id_lut", None))
              and s._int_id_lut() is not None)
        if not ok and self.device_negatives is True:
            # an explicit True that cannot be honoured must not silently
            # fall back to the host path
            raise ValueError(
                "device_negatives=True requires a sampler with a "
                "popularity distribution and an integer-id vocab "
                "(pop_random over int item ids); this sampler exposes "
                "neither — drop the flag to auto-select or pass "
                "device_negatives=False for the host path")
        return ok

    def _sampler_constants(self, device) -> tuple:
        """``(logp [V], vocab_ids [V])`` on ``device``, rebuilt when the
        sampler's distribution is another array object."""
        cached = self._device_consts
        if cached is not None and cached[0] is self.sampler._probs \
                and cached[1] == device:
            return cached[2], cached[3]
        logp = ns.popularity_logp(self.sampler._probs, device)
        vocab_ids = torch.from_numpy(
            np.asarray(self.sampler.vocab, dtype=np.int32)).to(device)
        self._device_consts = (self.sampler._probs, device, logp, vocab_ids)
        return logp, vocab_ids

    def _build_without_idx(self, labels, gt_ids, valid) -> np.ndarray:
        """``[B, P, W]`` sampler-vocab indices to exclude per position: the
        sequence's labels + the ground truth (reference :90-95), padded with
        ``len(vocab)`` (ignored by the sampler). W is a power of two >=
        S + 1, independent of the data."""
        lut = self.sampler._int_id_lut()
        b, p = gt_ids.shape
        s = labels.shape[1]
        v = len(self.sampler.vocab)
        in_range = (labels > 0) & (labels < len(lut))
        idx = lut[np.where(in_range, labels, 0)]
        idx = np.where(in_range & (idx >= 0), idx, v).astype(np.int32)

        width = max(8, 1 << s.bit_length())
        out = np.full((b, p, width), v, dtype=np.int32)
        out[:, :, :s] = idx[:, None, :]
        safe_gt = np.where(gt_ids < len(lut), gt_ids, 0)
        gt_idx = lut[safe_gt]
        rows, cols = np.nonzero(valid & (gt_idx >= 0))
        out[rows, cols, -1] = gt_idx[rows, cols]
        # the device sampler cannot raise per row: warn once if a row's
        # exclusion set could exhaust the pool of items with mass (top-k
        # would then return excluded or zero-mass items as negatives)
        if not getattr(self, "_warned_small_pool", False):
            pool = int(np.count_nonzero(self.sampler._probs > 0))
            max_excl = int((out != v).sum(axis=-1).max(initial=0))
            if pool - max_excl < self.sample_size:
                self._warned_small_pool = True
                warnings.warn(
                    f"negative-sampling pool may be too small: {pool} "
                    f"items carry probability mass, up to {max_excl} are "
                    f"excluded per position, sample_size="
                    f"{self.sample_size} — short rows will receive "
                    f"excluded/zero-mass items as negatives")
        return out

    def _batch_generator(self, device) -> torch.Generator:
        """This batch's generator: seeded with ``fold_in(seed, batch
        index)``, so one evaluator seed repeats every draw. Without a seed
        a fresh one is drawn, on a mesh rank 0's for every rank."""
        if self._base_seed is None:
            if self.seed is not None:
                self._base_seed = self.seed
            else:
                seed = torch.tensor(
                    int(np.random.SeedSequence().generate_state(1)[0]),
                    dtype=torch.int64, device=device)
                if self.mesh is not None:
                    mesh_lib.broadcast_world(seed)
                self._base_seed = int(seed)
        seed = fold_in(self._base_seed, self._batch_counter)
        if self.mesh is not None and self.mesh.size(DATA_AXIS) > 1:
            seed = fold_in(seed, self.mesh.index(DATA_AXIS))
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self._batch_counter += 1
        return gen

    def _evaluate_batch_device(self, model, params, batch, labels, gt_ids,
                               valid, device):
        without_idx = self._build_without_idx(labels, gt_ids, valid)
        gen = self._batch_generator(device)
        logp, vocab_ids = self._sampler_constants(device)
        placed = self._place(batch, device, without=without_idx)
        without = placed.pop("without")
        return ns.ranks_with_device_negatives(
            model, params, placed, logp=logp, vocab_ids=vocab_ids,
            without_idx=without, generator=gen,
            sample_size=self.sample_size, mesh=self.mesh)

    # ------------------------------------------------------------------ #
    # full-vocab (unsampled) ranking
    # ------------------------------------------------------------------ #

    def _evaluate_batch_full(self, model, params, batch, labels, gt_ids,
                             valid, device):
        """Full-catalog ranks of one batch. The competitors exclude the
        sampled protocol's set: the sequence's labels + the ground truths
        (the ground truth never counts itself)."""
        exclude = np.concatenate(
            [np.where(labels > 0, labels, -1),
             np.where(valid, gt_ids, -1)], axis=1).astype(np.int32)
        placed = self._place(batch, device, exclude=exclude)
        exclude = placed.pop("exclude")
        ranks = model.gt_ranks_full_vocab(
            params, placed, exclude=exclude,
            **mesh_lib.mesh_kwargs(model.gt_ranks_full_vocab, self.mesh))
        # invalid positions -> 0, the contract of the sampled paths
        return torch.where(placed["masked_lm_weights"] > 0, ranks,
                           torch.zeros_like(ranks))

    # ------------------------------------------------------------------ #

    def _sample_negatives(self, without_lists, n: int) -> np.ndarray:
        """[N, sample_size] negative ids, one row per masked position."""
        vocab_arr = np.asarray(self.sampler.vocab)
        if hasattr(self.sampler, "sample_batch"):
            idx = self.sampler.sample_batch(without_lists, self.sample_size)
            return vocab_arr[idx]
        rows = [self.sampler.sample(self.sample_size, without=list(w))
                for w in without_lists]
        return np.asarray(rows)

    def evaluate_batch(self, model, params, batch: dict,
                       fetch: bool = True):
        """Rank the ground truths of one host feature batch; returns the
        valid ranks. ``fetch=False`` returns the ``[B, P]`` rank tensor on
        the card (0 = invalid position) without waiting for it."""
        labels = np.asarray(batch["labels"])
        positions = np.asarray(batch["masked_lm_positions"])
        gt_ids = np.asarray(batch["masked_lm_ids"])
        weights = np.asarray(batch["masked_lm_weights"])
        b, p = positions.shape
        valid = weights > 0

        # masked slots fill in ascending order, so valid slots are a prefix
        # per row: slice P down to the most used (1 for leave-one-out)
        p_used = max(int(valid.sum(axis=1).max(initial=0)), 1)
        if self._static_shapes:
            p_used = p
        p_used = self._agreed_width(p_used)
        if p_used < p:
            gt_ids = gt_ids[:, :p_used]
            valid = valid[:, :p_used]
            batch = dict(batch)
            batch["masked_lm_positions"] = positions[:, :p_used]
            batch["masked_lm_ids"] = gt_ids
            batch["masked_lm_weights"] = weights[:, :p_used]
            p = p_used

        if not valid.any() and not self._static_shapes and self.mesh is None:
            return np.empty(0, dtype=np.int64)

        device = _model_device(model, params)
        with torch.no_grad():
            if self.full_ranking:
                ranks = self._evaluate_batch_full(model, params, batch,
                                                  labels, gt_ids, valid,
                                                  device)
            elif self._device_sampling_available():
                ranks = self._evaluate_batch_device(model, params, batch,
                                                    labels, gt_ids, valid,
                                                    device)
            else:
                ranks = self._evaluate_batch_host(model, params, batch,
                                                  labels, gt_ids, valid,
                                                  device)
        if ranks is None:
            return np.empty(0, dtype=np.int64)
        if self.mesh is not None:
            # every 'data' coordinate's ranks, in axis order, on every rank
            ranks = mesh_lib.gather(self.mesh, ranks,
                                    DATA_AXIS).reshape(-1, ranks.shape[-1])
        if not fetch:
            return ranks
        ranks = _fetch(ranks)
        return ranks[ranks > 0]

    def _evaluate_batch_host(self, model, params, batch, labels, gt_ids,
                             valid, device):
        # exclusion set per masked position: the sequence's labels + the
        # ground truth (reference :90-95), int arrays for the sampler's
        # vectorized scatter
        b, p = gt_ids.shape
        seq_without = [labels[i][labels[i] != 0] for i in range(b)]
        rows, cols = np.nonzero(valid)
        without_lists = [
            np.concatenate([seq_without[i], gt_ids[i, j:j + 1]])
            for i, j in zip(rows, cols)]
        if not without_lists and not self._static_shapes \
                and self.mesh is None:
            return None
        candidates = np.zeros((b, p, self.sample_size + 1), dtype=np.int32)
        if without_lists:
            candidates[rows, cols, :-1] = self._sample_negatives(
                without_lists, len(without_lists))
        candidates[..., -1] = gt_ids  # ground truth last (reference :101)
        placed = self._place(batch, device, candidates=candidates)
        return ns.ranks_from_candidates(model, params, placed,
                                        placed.pop("candidates"), self.mesh)

    def evaluate(self, model, params=None, test_ds=None,
                 batch_size: int = 256, seed: int = 0,
                 progress_bar: bool = True) -> dict:
        """Evaluate over a ProcessedDataset (or an iterable of host feature
        batches). ``model`` may be a ``BERT4RecModelWrapper`` (params taken
        from it). ``seed`` seeds only the dataset's masking; the negatives
        follow the constructor's ``seed``."""
        if params is None and hasattr(model, "params"):
            model, params = model.model, model.params
        self._prepare_sampler()
        self._batch_counter = 0   # the same streams on every run
        if self.seed is None:
            self._base_seed = None   # fresh negatives per unseeded run

        if hasattr(test_ds, "batches"):
            # a mesh needs every rank to run the same batches: the final
            # one is zero-padded (its fake rows carry weight 0)
            batches = prefetch(test_ds.batches(
                batch_size, shuffle=False, seed=seed,
                pad_final_batch=self.mesh is not None), depth=2)
        else:
            batches = test_ds
        iterator = batches
        if progress_bar:
            try:
                import tqdm
                iterator = tqdm.tqdm(batches, desc="evaluating")
            except ImportError:
                pass
        for ranks in fetch_pipelined(
                iterator,
                dispatch=lambda batch: self.evaluate_batch(
                    model, params, batch, fetch=False),
                fetch=_fetch, workers=self.fetch_workers):
            self._update_metrics(ranks)
        return self.get_metrics_results()

    def _update_metrics(self, ranks) -> None:
        ranks = np.asarray(ranks)
        if ranks.ndim > 1:
            ranks = ranks[ranks > 0]
        for metric in self._metrics:
            metric.update_batch(ranks)
