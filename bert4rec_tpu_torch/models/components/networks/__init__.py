from bert4rec_tpu_torch.models.components.networks.bert4rec_encoder import (
    Bert4RecEncoder,
)

__all__ = ["Bert4RecEncoder"]
