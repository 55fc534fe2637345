from bert4rec_tpu_torch.models.components import layers, transformer
from bert4rec_tpu_torch.models.components.networks import Bert4RecEncoder

__all__ = ["layers", "transformer", "Bert4RecEncoder"]
