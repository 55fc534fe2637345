"""Mixed-precision policy (port of ``bert4rec_tpu/core/dtypes.py``):
fp32 params; matmuls in ``compute_dtype``; layer norm, softmax and logits
always accumulate in fp32."""

import dataclasses

import torch


def enable_fast_prng() -> None:
    """Nothing to switch: JAX's counterpart moves its default PRNG to the
    TPU's cheaper 'rbg' bits, but the port's dropout is already a counter
    hash (``ops/dropout_bits.py``, the same in the CUDA kernels), so it
    changes no stream. Kept so that code written for the JAX package
    (``bench.py``) runs unchanged."""


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @classmethod
    def bf16(cls) -> "DTypePolicy":
        return cls(param_dtype=torch.float32, compute_dtype=torch.bfloat16)

    @classmethod
    def f32(cls) -> "DTypePolicy":
        return cls(param_dtype=torch.float32, compute_dtype=torch.float32)
