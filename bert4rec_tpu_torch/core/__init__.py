from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.core.dtypes import DTypePolicy

__all__ = ["DTypePolicy", "resolve_device"]
