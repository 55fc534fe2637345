from bert4rec_tpu_torch.models.bert4rec_model import (
    SPECIAL_TOKEN_IDS,
    BERT4RecModel,
)
from bert4rec_tpu_torch.models.bert4rec_wrapper import BERT4RecModelWrapper
from bert4rec_tpu_torch.models.components.networks import Bert4RecEncoder
from bert4rec_tpu_torch.models.config import BERT4RecConfig
from bert4rec_tpu_torch.models.model_wrapper import ModelWrapper
from bert4rec_tpu_torch.models.sasrec_model import SASRecModel
from bert4rec_tpu_torch.models import export, model_utils, quantization

__all__ = ["BERT4RecConfig", "BERT4RecModel", "BERT4RecModelWrapper",
           "Bert4RecEncoder", "ModelWrapper", "SASRecModel",
           "SPECIAL_TOKEN_IDS", "export", "model_utils", "quantization"]
