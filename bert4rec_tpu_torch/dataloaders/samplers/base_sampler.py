"""Abstract negative sampler (reference ``samplers/base_sampler.py:5-77``;
port of ``bert4rec_tpu/dataloaders/samplers/base_sampler.py``).

Holds a ``source`` (item list with duplicates — popularity evidence), a
``vocab`` (unique items) and a ``sample_size``; call-time arguments override
init-time ones.
"""

import abc
from typing import Optional


class BaseSampler(abc.ABC):

    def __init__(self, source: Optional[list] = None,
                 vocab: Optional[list] = None,
                 sample_size: Optional[int] = None):
        self.source = source
        self.vocab = vocab
        self.sample_size = sample_size

    def _get_parameters(self, source=None, vocab=None, sample_size=None):
        """Call-time args fall back to init-time values."""
        if source is None:
            source = self.source
        if vocab is None:
            vocab = self.vocab
        if sample_size is None:
            sample_size = self.sample_size
        if sample_size is None:
            raise ValueError(
                "The sample_size argument has to be given either during the "
                "initialization of the sampler or in the sample method call.")
        return source, vocab, sample_size

    @abc.abstractmethod
    def sample(self, sample_size: Optional[int] = None,
               without: Optional[list] = None, **kwargs) -> list:
        ...

    @abc.abstractmethod
    def is_fully_prepared(self) -> bool:
        ...

    def set_source(self, source: list):
        self.source = source

    def set_vocab(self, vocab: list):
        self.vocab = vocab

    def set_sample_size(self, sample_size: int):
        self.sample_size = sample_size
