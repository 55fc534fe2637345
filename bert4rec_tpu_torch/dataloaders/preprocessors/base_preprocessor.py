"""Abstract preprocessor (reference ``preprocessors/base_preprocessor.py:5-42``;
port of ``bert4rec_tpu/dataloaders/preprocessors/base_preprocessor.py``).

Instance-based rather than the reference's class-level global state
(bert4rec_preprocessor.py:23-45, a documented quirk) — two dataloaders no
longer clobber each other's config.
"""

import abc


class BasePreprocessor(abc.ABC):

    @abc.abstractmethod
    def set_properties(self, **kwargs):
        ...

    @abc.abstractmethod
    def process_element(self, sequence, apply_mlm: bool, finetuning: bool) -> dict:
        ...

    @abc.abstractmethod
    def process_dataset(self, ds, apply_mlm: bool, finetuning: bool):
        ...

    @abc.abstractmethod
    def prepare_inference(self, data) -> dict:
        ...
