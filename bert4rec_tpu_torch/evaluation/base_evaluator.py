"""Abstract evaluator (port of ``bert4rec_tpu/evaluation/base_evaluator.py``;
reference ``bert4rec/evaluation/base_evaluator.py:14-79``)."""

import abc
import json
import pathlib
import warnings
from typing import List, Optional

from bert4rec_tpu_torch.dataloaders import samplers as samplers_lib
from bert4rec_tpu_torch.dataloaders.processed_dataset import (
    _distributed_rank_and_size,
)
from bert4rec_tpu_torch.evaluation.evaluation_metrics import EvaluationMetric


class BaseEvaluator(abc.ABC):

    def __init__(self, metrics: List[EvaluationMetric],
                 sampler="random",
                 dataloader=None,
                 sampler_config: Optional[dict] = None):
        self._metrics = metrics
        self.dataloader = dataloader
        if sampler is None:  # sampler-free protocols (full-vocab ranking)
            self.sampler = None
            return
        self.sampler = samplers_lib.get(sampler, **(sampler_config or {}))
        if not self.sampler.is_fully_prepared():
            warnings.warn(
                "The sampler is not fully prepared (missing sample_size, "
                "source or vocab); they must be supplied before/at evaluate "
                "time.")

    @property
    def metrics(self) -> List[EvaluationMetric]:
        return self._metrics

    @abc.abstractmethod
    def evaluate(self, *args, **kwargs) -> dict:
        ...

    def get_metrics_results(self) -> dict:
        """name -> value dict (reference :56-62)."""
        return {m.name: m.result() for m in self._metrics}

    def reset_metrics(self) -> None:
        for m in self._metrics:
            m.reset()

    def save_results(self, save_path,
                     file_name: str = "eval_results.json") -> pathlib.Path:
        """JSON export (reference :64-79). Under ``torch.distributed`` rank
        0 writes (every rank holds the same metrics; concurrent writers to
        one shared path would interleave) and the ranks meet at a barrier,
        so the returned path exists for all of them."""
        save_path = pathlib.Path(save_path)
        out = save_path / file_name
        rank, world = _distributed_rank_and_size()
        if rank == 0:
            save_path.mkdir(parents=True, exist_ok=True)
            with open(out, "w") as f:
                json.dump(self.get_metrics_results(), f, indent=2)
        if world > 1:
            import torch.distributed as dist
            dist.barrier()
        return out
