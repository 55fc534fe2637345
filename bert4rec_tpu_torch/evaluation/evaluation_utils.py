"""Evaluation helpers (port of ``bert4rec_tpu/evaluation/evaluation_utils.py``;
reference ``bert4rec/evaluation/evaluation_utils.py:5-36``)."""

import random
from typing import List, Optional


def remove_elements_from_list(source: list, remove: list) -> list:
    """Return ``source`` without any element of ``remove`` (reference :5-17)."""
    removal = set(remove)
    return [x for x in source if x not in removal]


def sample_random_items_from_list(source: list, sample_size: int,
                                  seed: Optional[int] = None) -> List:
    """Uniform sample without replacement (reference :20-36)."""
    if sample_size >= len(source):
        return list(source)
    rng = random.Random(seed)
    return rng.sample(source, sample_size)
