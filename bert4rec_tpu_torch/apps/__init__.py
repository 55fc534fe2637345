"""Inference apps + online serving runtime."""

from bert4rec_tpu_torch.apps.recommender import (
    ArtifactRecommender, Recommender,
)
from bert4rec_tpu_torch.apps.ranker import Ranker
from bert4rec_tpu_torch.apps.serving import (
    MicroBatcher, RecommenderService, ServingServer,
)

__all__ = ["ArtifactRecommender", "Recommender", "Ranker", "MicroBatcher",
           "RecommenderService", "ServingServer"]
