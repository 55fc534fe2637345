from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.core.dtypes import DTypePolicy, enable_fast_prng

__all__ = ["DTypePolicy", "enable_fast_prng", "resolve_device"]
