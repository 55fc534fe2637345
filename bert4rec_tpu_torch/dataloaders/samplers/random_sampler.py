"""Uniform random sampler (reference ``samplers/random_sampler.py``; port
of ``bert4rec_tpu/dataloaders/samplers/random_sampler.py``).

Uniform choice without replacement over ``vocab`` minus ``without``
(random_sampler.py:63-79); vocab derived from source de-dup when absent
(:21-23).
"""

from typing import Optional

import numpy as np

from bert4rec_tpu_torch.dataloaders.samplers.base_sampler import BaseSampler


class RandomSampler(BaseSampler):

    def __init__(self, source: Optional[list] = None,
                 vocab: Optional[list] = None,
                 sample_size: Optional[int] = None,
                 seed: Optional[int] = None):
        if vocab is None and source is not None:
            vocab = list(dict.fromkeys(source))
        super().__init__(source, vocab, sample_size)
        self._rng = np.random.default_rng(seed)

    def is_fully_prepared(self) -> bool:
        return self.vocab is not None and self.sample_size is not None

    def sample(self, sample_size: Optional[int] = None,
               source: Optional[list] = None,
               vocab: Optional[list] = None,
               without: Optional[list] = None,
               seed: Optional[int] = None) -> list:
        source, vocab, sample_size = self._get_parameters(
            source, vocab, sample_size)
        if vocab is None and source is not None:
            vocab = list(dict.fromkeys(source))
        if vocab is None:
            raise ValueError(
                "The vocab argument has to be given either during the "
                "initialization of the sampler or in the sample method call.")
        rng = np.random.default_rng(seed) if seed is not None else self._rng

        candidates = vocab
        if without:
            excluded = set(without)
            candidates = [v for v in vocab if v not in excluded]
        if sample_size > len(candidates):
            raise ValueError(
                f"Can not sample {sample_size} items without replacement from "
                f"a remaining candidate pool of {len(candidates)}.")
        idx = rng.choice(len(candidates), size=sample_size, replace=False)
        return [candidates[i] for i in idx]
