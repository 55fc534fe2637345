"""SASRec: causal next-item recommendation (port of
``bert4rec_tpu/models/sasrec_model.py``).

The same encoder, head, params, trainer and evaluator as BERT4Rec with two
switches:

- ``config.causal_attention=True``: position i attends only to j <= i (the
  fused layer's causal kernels, or the triangle folded into the unfused
  block's bias);
- the ``"next_item"`` dataset task (``dataloaders/processed_dataset.py``):
  the final item leaves the input and every remaining position predicts
  its successor, in the ``masked_lm_*`` feature contract, so the loss
  kernels and the evaluator run unchanged.

Scoring keeps the BERT-style transform head before the tied table, as the
JAX package does.
"""

from typing import Optional, Sequence

from bert4rec_tpu_torch.core.dtypes import DTypePolicy
from bert4rec_tpu_torch.models.bert4rec_model import (
    SPECIAL_TOKEN_IDS,
    BERT4RecModel,
)
from bert4rec_tpu_torch.models.components.networks import Bert4RecEncoder
from bert4rec_tpu_torch.models.config import BERT4RecConfig


class SASRecModel(BERT4RecModel):
    """BERT4RecModel with causal attention enforced: a config is flipped to
    ``causal_attention=True``; an encoder must already be causal."""

    def __init__(self,
                 encoder: Bert4RecEncoder = None,
                 config: BERT4RecConfig = None,
                 special_token_ids: Sequence[int] = tuple(SPECIAL_TOKEN_IDS),
                 dtype_policy: Optional[DTypePolicy] = None):
        if encoder is None:
            if config is None:
                raise ValueError("Provide either an encoder or a config")
            if not config.causal_attention:
                config = config.replace(causal_attention=True)
        elif not encoder.config.causal_attention:
            raise ValueError(
                "SASRecModel needs a causal encoder; build it from a config "
                "with causal_attention=True (or pass the config directly)")
        super().__init__(encoder=encoder, config=config,
                         special_token_ids=special_token_ids,
                         dtype_policy=dtype_policy)
