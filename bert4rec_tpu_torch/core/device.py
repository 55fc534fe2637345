"""Device resolution shared by every entry point of the port.

Entry points default to ``"cuda"``. Without CUDA they raise instead of
carrying on silently on the CPU: a caller who wants the CPU (the tests)
asks for it with ``device="cpu"``.
"""

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device
