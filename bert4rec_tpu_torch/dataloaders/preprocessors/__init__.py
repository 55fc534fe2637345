"""Preprocessors (port of ``bert4rec_tpu/dataloaders/preprocessors``): the
BERT4Rec, temporal BERT4Rec and SASRec ones."""

from bert4rec_tpu_torch.dataloaders.preprocessors.base_preprocessor import (
    BasePreprocessor,
)
from bert4rec_tpu_torch.dataloaders.preprocessors.bert4rec_preprocessor import (
    BERT4RecPreprocessor,
)
from bert4rec_tpu_torch.dataloaders.preprocessors.bert4rec_temporal_preprocessor import (  # noqa: E501
    BERT4RecTemporalPreprocessor,
)
from bert4rec_tpu_torch.dataloaders.preprocessors.sasrec_preprocessor import (
    SASRecPreprocessor,
)

preprocessors_map = {
    "bert4rec": BERT4RecPreprocessor,
    "bert4rec_temporal": BERT4RecTemporalPreprocessor,
    "sasrec": SASRecPreprocessor,
}


def get(identifier="bert4rec", **kwargs):
    if isinstance(identifier, BasePreprocessor):
        return identifier
    if isinstance(identifier, type) and issubclass(identifier, BasePreprocessor):
        return identifier(**kwargs)
    if identifier in preprocessors_map:
        return preprocessors_map[identifier](**kwargs)
    raise ValueError(f"{identifier} is not a known preprocessor identifier!")


__all__ = ["BasePreprocessor", "BERT4RecPreprocessor",
           "BERT4RecTemporalPreprocessor", "SASRecPreprocessor",
           "preprocessors_map", "get"]
