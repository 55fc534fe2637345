"""Preprocessors (port of ``bert4rec_tpu/dataloaders/preprocessors``): the
BERT4Rec one; the temporal and SASRec preprocessors come with their model
slices."""

from bert4rec_tpu_torch.dataloaders.preprocessors.base_preprocessor import (
    BasePreprocessor,
)
from bert4rec_tpu_torch.dataloaders.preprocessors.bert4rec_preprocessor import (
    BERT4RecPreprocessor,
)

preprocessors_map = {
    "bert4rec": BERT4RecPreprocessor,
}


def get(identifier="bert4rec", **kwargs):
    if isinstance(identifier, BasePreprocessor):
        return identifier
    if isinstance(identifier, type) and issubclass(identifier, BasePreprocessor):
        return identifier(**kwargs)
    if identifier in preprocessors_map:
        return preprocessors_map[identifier](**kwargs)
    raise ValueError(f"{identifier} is not a known preprocessor identifier!")


__all__ = ["BasePreprocessor", "BERT4RecPreprocessor", "preprocessors_map",
           "get"]
