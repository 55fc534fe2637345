"""Deterministic most-popular sampler (reference
``samplers/popular_sampler.py``; port of
``bert4rec_tpu/dataloaders/samplers/popular_sampler.py``).

Top-``sample_size`` of the popularity-ranked source after removing ``without``
(popular_sampler.py:53-71).
"""

from typing import Optional

from bert4rec_tpu_torch.dataloaders import dataloader_utils
from bert4rec_tpu_torch.dataloaders.samplers.base_sampler import BaseSampler


class PopularSampler(BaseSampler):

    def __init__(self, source: Optional[list] = None,
                 vocab: Optional[list] = None,
                 sample_size: Optional[int] = None):
        super().__init__(source, vocab, sample_size)
        self._ranked = None
        if source is not None:
            self._ranked = dataloader_utils.rank_items_by_popularity(source)

    def is_fully_prepared(self) -> bool:
        return self._ranked is not None and self.sample_size is not None

    def sample(self, sample_size: Optional[int] = None,
               source: Optional[list] = None,
               vocab: Optional[list] = None,
               without: Optional[list] = None) -> list:
        source, vocab, sample_size = self._get_parameters(
            source, vocab, sample_size)
        if source is None:
            raise ValueError(
                "The source argument has to be given either during the "
                "initialization of the sampler or in the sample method call "
                "when working with the popular sampler.")
        ranked = self._ranked
        if ranked is None or source is not self.source:
            ranked = dataloader_utils.rank_items_by_popularity(source)
        if without:
            excluded = set(without)
            ranked = [i for i in ranked if i not in excluded]
        if sample_size > len(ranked):
            raise ValueError(
                f"Can not sample {sample_size} items from a remaining "
                f"candidate pool of {len(ranked)}.")
        return ranked[:sample_size]

    def set_source(self, source: list):
        super().set_source(source)
        self._ranked = dataloader_utils.rank_items_by_popularity(source)
