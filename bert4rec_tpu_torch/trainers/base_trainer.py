"""Abstract trainer (port of ``bert4rec_tpu/trainers/base_trainer.py``)."""

import abc
import datetime


class BaseTrainer(abc.ABC):

    def __init__(self, model):
        self.model = model
        self.optimizer = None
        self.loss = None
        self.metrics = None
        self.callbacks = []

    @abc.abstractmethod
    def initialize_model(self, *args, **kwargs):
        ...

    @abc.abstractmethod
    def train(self, *args, **kwargs):
        ...

    @abc.abstractmethod
    def validate(self, *args, **kwargs):
        ...

    def update_wrapper_meta_info(self, wrapper, dataloader=None) -> None:
        """Stamp ``last_trained`` and ``trained_on_dataset``."""
        updated_info = {
            "last_trained": datetime.datetime.now().strftime(
                "%Y-%m-%d %H:%M:%S"),
        }
        if dataloader is not None:
            updated_info["trained_on_dataset"] = dataloader.dataset_identifier
        wrapper.update_meta(updated_info)

    def append_callback(self, callback) -> None:
        if callback is None:
            raise ValueError("The provided callback is None and can therefore "
                             "not be appended")
        self.callbacks.append(callback)
