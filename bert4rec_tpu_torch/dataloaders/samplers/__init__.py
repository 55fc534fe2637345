"""Sampler factory (reference ``samplers/__init__.py:9-30``; port of
``bert4rec_tpu/dataloaders/samplers``: numpy copies, the same draws for
one seed)."""

from typing import Union

from bert4rec_tpu_torch.dataloaders.samplers.base_sampler import BaseSampler
from bert4rec_tpu_torch.dataloaders.samplers.random_sampler import RandomSampler
from bert4rec_tpu_torch.dataloaders.samplers.popular_sampler import PopularSampler
from bert4rec_tpu_torch.dataloaders.samplers.popular_random_sampler import PopularRandomSampler

samplers_map = {
    "random": RandomSampler,
    "popular": PopularSampler,
    "pop_random": PopularRandomSampler,
    "popular_random": PopularRandomSampler,
}


def get(identifier: Union[str, BaseSampler] = "random", **kwargs) -> BaseSampler:
    if isinstance(identifier, BaseSampler):
        return identifier
    if identifier in samplers_map:
        return samplers_map[identifier](**kwargs)
    raise ValueError(f"{identifier} is not a known sampler identifier!")


__all__ = ["BaseSampler", "RandomSampler", "PopularSampler",
           "PopularRandomSampler", "samplers_map", "get"]
