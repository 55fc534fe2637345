"""Trainers: the train step, the clip + AdamW optimizer, callbacks (port of
``bert4rec_tpu/trainers``)."""

from bert4rec_tpu_torch.trainers import callbacks, optimizers, trainer_utils
from bert4rec_tpu_torch.trainers.base_trainer import BaseTrainer
from bert4rec_tpu_torch.trainers.bert4rec_trainer import BERT4RecTrainer
from bert4rec_tpu_torch.trainers.callbacks import (
    Callback, EarlyStopping, History, JSONLLogger, ModelCheckpoint,
)

trainers_map = {
    "bert4rec": BERT4RecTrainer,
}


def get(identifier="bert4rec", **kwargs):
    """Factory: a trainer instance passes through, a name builds one."""
    if isinstance(identifier, BaseTrainer):
        return identifier
    if identifier in trainers_map:
        return trainers_map[identifier](**kwargs)
    raise ValueError(f"{identifier} is not a known trainer identifier!")


__all__ = ["BaseTrainer", "BERT4RecTrainer", "callbacks", "optimizers",
           "trainer_utils", "Callback", "EarlyStopping", "History",
           "JSONLLogger", "ModelCheckpoint", "trainers_map", "get"]
