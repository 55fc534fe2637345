"""The port's CUDA kernels held against their plain versions on the card.

Imports neither JAX nor ``bert4rec_tpu``, so it also runs on a machine
without them; there ``tests/conftest.py`` (which imports JAX) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
from bert4rec_tpu_torch.utils.checkpoint import flatten, params_from_numpy


def layer_params_np(rng, h, n, f):
    """One encoder layer's params in the JAX layout (qkv ``[H,3,N,D]``,
    output ``[N,D,H]``) with every leaf random, so the bias and LayerNorm
    epilogues are exercised."""
    d = h // n

    def w(*shape, scale=0.2):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {
        "attention": {
            "qkv": {"kernel": w(h, 3, n, d), "bias": w(3, n, d, scale=0.1)},
            "output": {"kernel": w(n, d, h), "bias": w(h, scale=0.1)},
        },
        "attention_norm": {"scale": 1.0 + w(h, scale=0.1),
                           "bias": w(h, scale=0.1)},
        "intermediate": {"kernel": w(h, f), "bias": w(f, scale=0.1)},
        "output": {"kernel": w(f, h), "bias": w(h, scale=0.1)},
        "output_norm": {"scale": 1.0 + w(h, scale=0.1),
                        "bias": w(h, scale=0.1)},
    }


def inputs_np(rng, b, s, h):
    """``x [B, S, H]`` fp32 and an int32 pad mask of random lengths in
    ``[1, S]`` (row 0 unpadded)."""
    x = rng.normal(size=(b, s, h)).astype(np.float32)
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return x, mask


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [
    (4, 24, 32, 4, 64), (3, 200, 128, 4, 512), (2, 37, 96, 4, 200),
    (2, 130, 256, 2, 64), (1, 5, 512, 4, 96),
], ids=lambda d: "B{}_S{}_H{}_N{}_F{}".format(*d))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fused_layer_kernel_matches_plain(cuda_device, dims, dtype):
    b, s, h, n, f = dims
    rng = np.random.default_rng(sum(dims))
    p = params_from_numpy(flatten(layer_params_np(rng, h, n, f)),
                          cuda_device)
    x, mask = inputs_np(rng, b, s, h)
    xt = torch.from_numpy(x).to(cuda_device, dtype)
    mt = torch.from_numpy(mask).to(cuda_device)
    before = fel.fused_encoder_layer.launches
    out = fel.fused_encoder_layer(p, xt, mt, num_heads=n)
    torch.cuda.synchronize()
    assert fel.fused_encoder_layer.launches == before + 1
    assert out.dtype == dtype and out.shape == xt.shape
    ref = fel.fused_encoder_layer_plain(p, xt, mt, num_heads=n)
    # fp32: sums in another order only; bf16: a sum-order difference can
    # flip a bf16 rounding of an intermediate (JAX's own bf16 bound)
    tol = 1e-4 if dtype == torch.float32 else 8e-2
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_fused_layer_rejects_head_dim_beyond_kernel(cuda_device):
    rng = np.random.default_rng(0)
    p = params_from_numpy(flatten(layer_params_np(rng, 256, 1, 64)),
                          cuda_device)
    x, mask = inputs_np(rng, 1, 8, 256)
    with pytest.raises(ValueError):
        fel.fused_encoder_layer(p, torch.from_numpy(x).to(cuda_device),
                                torch.from_numpy(mask).to(cuda_device),
                                num_heads=1)
