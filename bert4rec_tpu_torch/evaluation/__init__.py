"""Evaluation: rank metrics and the sampled / full-catalog evaluator (port
of ``bert4rec_tpu/evaluation``), and the quality harness's temporal gate
(``quality_harness.run_smoke_temporal``); the baselines, the oracles and
the harness's other modes come with a later slice."""

from bert4rec_tpu_torch.evaluation import evaluation_metrics, evaluation_utils
from bert4rec_tpu_torch.evaluation.evaluation_metrics import (
    Counter, EvaluationMetric, HitRatio, HR, MAP, MeanAveragePrecision,
    NDCG, NormalizedDiscountedCumulativeGain,
)
from bert4rec_tpu_torch.evaluation.base_evaluator import BaseEvaluator
from bert4rec_tpu_torch.evaluation.bert4rec_evaluator import (
    BERT4RecEvaluator, default_metrics,
)

evaluators_map = {
    "bert4rec": BERT4RecEvaluator,
}


def get(identifier="bert4rec", **kwargs):
    if isinstance(identifier, BaseEvaluator):
        return identifier
    if identifier in evaluators_map:
        return evaluators_map[identifier](**kwargs)
    raise ValueError(f"{identifier} is not a known evaluator identifier!")


__all__ = ["evaluation_metrics", "evaluation_utils", "Counter",
           "EvaluationMetric", "HitRatio", "HR", "MAP",
           "MeanAveragePrecision", "NDCG",
           "NormalizedDiscountedCumulativeGain", "BaseEvaluator",
           "BERT4RecEvaluator", "default_metrics", "evaluators_map", "get"]
