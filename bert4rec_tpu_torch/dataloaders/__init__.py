"""Dataloaders: pipeline core, samplers + abstract factory (port of
``bert4rec_tpu/dataloaders/__init__.py``).

Mirrors reference ``bert4rec/dataloaders/__init__.py:13-60``.
"""

import abc

from bert4rec_tpu_torch.dataloaders.base_dataloader import BaseDataloader
from bert4rec_tpu_torch.dataloaders.bert4rec_dataloader import BERT4RecDataloader
from bert4rec_tpu_torch.dataloaders.concrete_dataloaders import (
    BERT4RecML1MDataloader,
    BERT4RecML20MDataloader,
    BERT4RecBeautyDataloader,
    BERT4RecSteamDataloader,
    BERT4RecRedditDataloader,
)
from bert4rec_tpu_torch.dataloaders.sequence_dataset import SequenceDataset, split_dataset
from bert4rec_tpu_torch.dataloaders.processed_dataset import ProcessedDataset, MaskingConfig
from bert4rec_tpu_torch.dataloaders import dataloader_utils
from bert4rec_tpu_torch.dataloaders import preprocessors
from bert4rec_tpu_torch.dataloaders import samplers


class BaseDataloaderFactory(abc.ABC):
    @abc.abstractmethod
    def create_ml_1m_dataloader(self, **kwargs) -> BaseDataloader: ...

    @abc.abstractmethod
    def create_ml_20m_dataloader(self, **kwargs) -> BaseDataloader: ...

    @abc.abstractmethod
    def create_beauty_dataloader(self, **kwargs) -> BaseDataloader: ...

    @abc.abstractmethod
    def create_steam_dataloader(self, **kwargs) -> BaseDataloader: ...

    @abc.abstractmethod
    def create_reddit_dataloader(self, **kwargs) -> BaseDataloader: ...


class BERT4RecDataloaderFactory(BaseDataloaderFactory):
    def create_ml_1m_dataloader(self, **kwargs) -> BERT4RecML1MDataloader:
        return BERT4RecML1MDataloader(**kwargs)

    def create_ml_20m_dataloader(self, **kwargs) -> BERT4RecML20MDataloader:
        return BERT4RecML20MDataloader(**kwargs)

    def create_beauty_dataloader(self, **kwargs) -> BERT4RecBeautyDataloader:
        return BERT4RecBeautyDataloader(**kwargs)

    def create_steam_dataloader(self, **kwargs) -> BERT4RecSteamDataloader:
        return BERT4RecSteamDataloader(**kwargs)

    def create_reddit_dataloader(self, **kwargs) -> BERT4RecRedditDataloader:
        return BERT4RecRedditDataloader(**kwargs)


def get_dataloader_factory(identifier: str = "bert4rec") -> BaseDataloaderFactory:
    """reference dataloaders/__init__.py:56-60"""
    if identifier == "bert4rec":
        return BERT4RecDataloaderFactory()
    raise ValueError(f"{identifier} is not a known dataloader factory "
                     "identifier!")


__all__ = [
    "BaseDataloader", "BERT4RecDataloader",
    "BERT4RecML1MDataloader", "BERT4RecML20MDataloader",
    "BERT4RecBeautyDataloader", "BERT4RecSteamDataloader",
    "BERT4RecRedditDataloader",
    "SequenceDataset", "ProcessedDataset", "MaskingConfig", "split_dataset",
    "dataloader_utils", "preprocessors", "samplers",
    "BaseDataloaderFactory", "BERT4RecDataloaderFactory",
    "get_dataloader_factory",
]
