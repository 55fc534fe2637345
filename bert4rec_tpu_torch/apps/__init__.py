"""Inference apps + online serving runtime."""

from bert4rec_tpu_torch.apps.recommender import Recommender
from bert4rec_tpu_torch.apps.serving import (
    MicroBatcher, RecommenderService, ServingServer,
)

__all__ = ["Recommender", "MicroBatcher", "RecommenderService",
           "ServingServer"]
