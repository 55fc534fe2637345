"""Rank-based streaming evaluation metrics (port of
``bert4rec_tpu/evaluation/evaluation_metrics.py``; reference
``bert4rec/evaluation/evaluation_metrics.py:47-112``): Counter, HitRatio@k,
NDCG@k, MAP (mean reciprocal rank). Identical math; each metric also takes
a whole rank array in ``update_batch``, since the evaluator ranks a batch at
once."""

import abc
from typing import Optional

import numpy as np


class EvaluationMetric(abc.ABC):

    def __init__(self, name: str):
        self.name = name

    @abc.abstractmethod
    def update(self, rank: int) -> None:
        ...

    def update_batch(self, ranks: np.ndarray) -> None:
        for rank in np.asarray(ranks).reshape(-1):
            self.update(int(rank))

    @abc.abstractmethod
    def result(self):
        ...

    @abc.abstractmethod
    def reset(self) -> None:
        ...


class Counter(EvaluationMetric):
    """Counts processed ranks (reference :47-56)."""

    def __init__(self, name: str = "Counter"):
        super().__init__(name)
        self.count = 0

    def update(self, rank: int) -> None:
        self.count += 1

    def update_batch(self, ranks: np.ndarray) -> None:
        self.count += int(np.asarray(ranks).size)

    def result(self) -> int:
        return self.count

    def reset(self) -> None:
        self.count = 0


class HitRatio(EvaluationMetric):
    """HR@k: fraction of ranks <= k (reference :59-69)."""

    def __init__(self, k: int = 10, name: Optional[str] = None):
        super().__init__(name or f"HR@{k}")
        self.k = k
        self.hits = 0
        self.n = 0

    def update(self, rank: int) -> None:
        self.n += 1
        if rank <= self.k:
            self.hits += 1

    def update_batch(self, ranks: np.ndarray) -> None:
        ranks = np.asarray(ranks).reshape(-1)
        self.n += ranks.size
        self.hits += int((ranks <= self.k).sum())

    def result(self) -> float:
        return self.hits / self.n if self.n else 0.0

    def reset(self) -> None:
        self.hits = 0
        self.n = 0


class NormalizedDiscountedCumulativeGain(EvaluationMetric):
    """NDCG@k: 1/log2(rank+1) for rank <= k else 0, averaged
    (reference :72-86 — rank 1 contributes exactly 1)."""

    def __init__(self, k: int = 10, name: Optional[str] = None):
        super().__init__(name or f"NDCG@{k}")
        self.k = k
        self.total = 0.0
        self.n = 0

    def update(self, rank: int) -> None:
        self.n += 1
        if rank <= self.k:
            self.total += 1.0 / np.log2(rank + 1)

    def update_batch(self, ranks: np.ndarray) -> None:
        ranks = np.asarray(ranks).reshape(-1)
        self.n += ranks.size
        hit = ranks <= self.k
        self.total += float((1.0 / np.log2(ranks[hit] + 1)).sum())

    def result(self) -> float:
        return self.total / self.n if self.n else 0.0

    def reset(self) -> None:
        self.total = 0.0
        self.n = 0


class MeanAveragePrecision(EvaluationMetric):
    """MAP = mean 1/rank, i.e. MRR for single-ground-truth ranking
    (reference :89-96)."""

    def __init__(self, name: str = "MAP"):
        super().__init__(name)
        self.total = 0.0
        self.n = 0

    def update(self, rank: int) -> None:
        self.n += 1
        self.total += 1.0 / rank

    def update_batch(self, ranks: np.ndarray) -> None:
        ranks = np.asarray(ranks, dtype=np.float64).reshape(-1)
        self.n += ranks.size
        self.total += float((1.0 / ranks).sum())

    def result(self) -> float:
        return self.total / self.n if self.n else 0.0

    def reset(self) -> None:
        self.total = 0.0
        self.n = 0


# aliases (reference :100-112)
HR = HitRatio
NDCG = NormalizedDiscountedCumulativeGain
MAP = MeanAveragePrecision
