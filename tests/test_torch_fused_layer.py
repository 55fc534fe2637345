"""The port's fused encoder layer (bert4rec_tpu_torch/ops/fused_encoder_layer.py)
held against the JAX package's Pallas kernel, run in interpret mode on the
CPU. The CUDA kernel itself is held against the plain version on a card
in tests/test_torch_cuda_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4rec_tpu.ops import fused_encoder_layer as jax_fel
from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
from bert4rec_tpu_torch.utils.checkpoint import (
    flatten, params_from_numpy, unflatten,
)
from tests.test_torch_cuda_kernels import inputs_np, layer_params_np

B, S, H, N, F = 4, 24, 32, 4, 64


def both(seed=0):
    """The same random layer for both packages, and its inputs."""
    rng = np.random.default_rng(seed)
    flat = flatten(layer_params_np(rng, H, N, F))
    x, mask = inputs_np(rng, B, S, H)
    jax_p = unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    return jax_p, params_from_numpy(flat, "cpu"), x, mask


class TestPlainVersusJaxKernel:

    @pytest.mark.parametrize("seed", [0, 1])
    def test_fp32_matches_interpret_kernel(self, seed):
        jax_p, torch_p, x, mask = both(seed)
        ref = jax_fel.fused_encoder_layer(jax_p, jnp.asarray(x),
                                          jnp.asarray(mask), num_heads=N,
                                          interpret=True)
        out = fel.fused_encoder_layer_plain(
            torch_p, torch.from_numpy(x), torch.from_numpy(mask),
            num_heads=N)
        # JAX's own kernel-vs-unfused check uses 2e-4; the plain version
        # mirrors the kernel's math, so 1e-4 holds
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)

    def test_bf16_matches_interpret_kernel(self):
        jax_p, torch_p, x, mask = both(2)
        ref = jax_fel.fused_encoder_layer(
            jax_p, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mask),
            num_heads=N, interpret=True)
        out = fel.fused_encoder_layer_plain(
            torch_p, torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(mask), num_heads=N)
        assert out.dtype == torch.bfloat16
        # the JAX package's bf16 tolerance for this kernel
        # (tests/ops_tests/test_fused_layer.py)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, dtype=np.float32),
                                   rtol=8e-2, atol=8e-2)

    def test_cpu_wrapper_runs_plain_and_counts_no_launch(self):
        _, torch_p, x, mask = both(3)
        xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
        before = fel.fused_encoder_layer.launches
        out = fel.fused_encoder_layer(torch_p, xt, mt, num_heads=N)
        assert fel.fused_encoder_layer.launches == before
        assert torch.equal(out, fel.fused_encoder_layer_plain(
            torch_p, xt, mt, num_heads=N))

    def test_flat_weights_layout_matches_jax(self):
        jax_p, torch_p, _, _ = both(4)
        ours = fel.flat_weights(torch_p)
        theirs = jax_fel._flat_weights(jax_p)
        assert set(ours) == set(theirs) == set(fel._W_ORDER)
        for k in fel._W_ORDER:
            np.testing.assert_array_equal(ours[k].numpy(),
                                          np.asarray(theirs[k]))


class TestWrapperRaises:

    @pytest.mark.parametrize("kwargs", [
        dict(causal=True),
        dict(rel_bias=torch.zeros(B, N, S, S)),
        dict(attention_dropout=0.2),
        dict(output_dropout=0.5),
    ], ids=["causal", "rel_bias", "attention_dropout", "output_dropout"])
    def test_unported_variants_raise(self, kwargs):
        _, torch_p, x, mask = both(0)
        with pytest.raises(NotImplementedError):
            fel.fused_encoder_layer(torch_p, torch.from_numpy(x),
                                    torch.from_numpy(mask), num_heads=N,
                                    **kwargs)

    def test_rejects_non_int32_mask(self):
        _, torch_p, x, mask = both(0)
        with pytest.raises(ValueError):
            fel.fused_encoder_layer(torch_p, torch.from_numpy(x),
                                    torch.from_numpy(mask).long(),
                                    num_heads=N)


class TestRoutingLawParity:

    @pytest.mark.parametrize("shape", [
        (256, 200, 128, 512, 4), (32, 200, 256, 1024, 8),
        (64, 200, 768, 3072, 12), (8, 512, 64, 256, 2),
        (8, 600, 64, 256, 2), (4, 24, 32, 64, 4), (2, 50, 96, 64, 5),
    ])
    @pytest.mark.parametrize("dtype_bytes", [2, 4])
    def test_fused_layer_supported_matches_jax(self, shape, dtype_bytes):
        b, s, h, f, n = shape
        kw = dict(batch=b, seq_len=s, hidden=h, inner_dim=f, num_heads=n,
                  dtype_bytes=dtype_bytes)
        assert fel.fused_layer_supported(**kw) \
            == jax_fel.fused_layer_supported(**kw)
        est = dict(kw)
        est.pop("num_heads")
        assert fel.estimate_vmem_bytes(**est) \
            == jax_fel.estimate_vmem_bytes(**est)
