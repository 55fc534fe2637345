"""Abstract dataloader API (reference ``base_dataloader.py:12-134``; port
of ``bert4rec_tpu/dataloaders/base_dataloader.py``)."""

import abc
from typing import Optional

from bert4rec_tpu_torch import tokenizers
from bert4rec_tpu_torch.dataloaders import dataloader_utils


class BaseDataloader(abc.ABC):

    def __init__(self, tokenizer: Optional[tokenizers.BaseTokenizer] = None,
                 data_source=None, preprocessor=None):
        self.tokenizer = tokenizer
        self.data_source = data_source
        self.preprocessor = preprocessor

    @property
    @abc.abstractmethod
    def dataset_identifier(self) -> str:
        ...

    def get_tokenizer(self):
        """reference base_dataloader.py tokenizer accessor parity"""
        return self.tokenizer

    @abc.abstractmethod
    def load_data(self, *args, **kwargs):
        ...

    @abc.abstractmethod
    def get_data(self, *args, **kwargs):
        ...

    @abc.abstractmethod
    def process_data(self, ds, apply_mlm: bool = True, finetuning: bool = False):
        ...

    @abc.abstractmethod
    def prepare_training(self, *args, **kwargs):
        ...

    @abc.abstractmethod
    def prepare_inference(self, data):
        ...

    @abc.abstractmethod
    def generate_vocab(self, source=None) -> bool:
        ...

    @abc.abstractmethod
    def create_item_list(self) -> list:
        ...

    def create_item_list_tokenized(self) -> list:
        """reference base_dataloader.py:122-126"""
        return self.tokenizer.tokenize(self.create_item_list())

    def create_popular_item_ranking(self) -> list:
        """reference base_dataloader.py:128-131"""
        return dataloader_utils.rank_items_by_popularity(self.create_item_list())

    def create_popular_item_ranking_tokenized(self) -> list:
        """reference base_dataloader.py:133-134"""
        return self.tokenizer.tokenize(self.create_popular_item_ranking())
