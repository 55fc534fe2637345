"""Evaluation: rank metrics, the sampled / full-catalog evaluator, the
popularity baseline, the Bayes oracles of the planted Markov worlds
(``markov_oracle``, ``temporal_oracle``) and the quality harness
(``quality_harness``; port of ``bert4rec_tpu/evaluation``)."""

from bert4rec_tpu_torch.evaluation import evaluation_metrics, evaluation_utils
from bert4rec_tpu_torch.evaluation.evaluation_metrics import (
    Counter, EvaluationMetric, HitRatio, HR, MAP, MeanAveragePrecision,
    NDCG, NormalizedDiscountedCumulativeGain,
)
from bert4rec_tpu_torch.evaluation.base_evaluator import BaseEvaluator
from bert4rec_tpu_torch.evaluation.baselines import PopularityScorer
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
           "BERT4RecEvaluator", "PopularityScorer", "default_metrics",
           "evaluators_map", "get"]
