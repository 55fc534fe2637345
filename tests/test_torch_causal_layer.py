"""The port's causal encoder layer (SASRec) held against the JAX package on
the CPU: the fused layer's plain version, forward and gradients, against
the Pallas kernel with ``causal=True`` in interpret mode (rate 0, right-
padded rows and one all-pad row); the unfused causal block against JAX's
encoder with ``use_fused_layer=False``; and the causal laws — outputs at
positions <= i do not depend on later tokens, a row that sees only padding
is uniform over its keys j <= i, analytic gradients equal finite
differences. The CUDA kernels are held against the plain version on a card
in tests/test_torch_cuda_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models.components.networks import (
    Bert4RecEncoder as JaxEncoder,
)
from bert4rec_tpu.ops import fused_encoder_layer as jax_fel
from bert4rec_tpu_torch.models import BERT4RecConfig, Bert4RecEncoder
from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
from bert4rec_tpu_torch.utils.checkpoint import (
    flatten, params_from_numpy, unflatten,
)
from tests.test_torch_cuda_kernels import inputs_np, layer_params_np
from tests.test_torch_fused_layer import (
    _JAX_PATHS, _rel_err, backward_3xtf32_errs, dropout_3xtf32_err,
)

B, S, H, N, F = 4, 24, 32, 4, 64
ALL_PAD = 2   # the row of `both` whose mask is all padding


def both(seed=0):
    """The same random layer for both packages, and its inputs: random
    right-padded lengths, row 0 unpadded, row ALL_PAD all padding."""
    rng = np.random.default_rng(seed)
    flat = flatten(layer_params_np(rng, H, N, F))
    x, mask = inputs_np(rng, B, S, H)
    mask[ALL_PAD] = 0
    jax_p = unflatten({k: jnp.asarray(v) for k, v in flat.items()})
    return jax_p, params_from_numpy(flat, "cpu"), x, mask


class TestCausalLayerVersusJaxKernel:

    @pytest.mark.parametrize("seed", [0, 1])
    def test_fp32_matches_interpret_kernel(self, seed):
        jax_p, torch_p, x, mask = both(seed)
        ref = jax_fel.fused_encoder_layer(jax_p, jnp.asarray(x),
                                          jnp.asarray(mask), num_heads=N,
                                          interpret=True, causal=True)
        out = fel.fused_encoder_layer(torch_p, torch.from_numpy(x),
                                      torch.from_numpy(mask), num_heads=N,
                                      causal=True)
        # the JAX package's own kernel bar is 2e-4; the plain version
        # repeats the kernel's math, all-pad row included
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)
        plain = fel.fused_encoder_layer(torch_p, torch.from_numpy(x),
                                        torch.from_numpy(mask), num_heads=N)
        assert float((out - plain).abs().max()) > 1e-2   # the triangle bites

    def test_bf16_matches_interpret_kernel(self):
        jax_p, torch_p, x, mask = both(2)
        ref = jax_fel.fused_encoder_layer(
            jax_p, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mask),
            num_heads=N, interpret=True, causal=True)
        out = fel.fused_encoder_layer_plain(
            torch_p, torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(mask), num_heads=N, causal=True)
        # the JAX package's bf16 bound for this kernel
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, dtype=np.float32),
                                   rtol=8e-2, atol=8e-2)

    @pytest.mark.parametrize("dtype,tol", [
        (torch.float32, 1e-4), (torch.bfloat16, 5e-3)], ids=["fp32", "bf16"])
    def test_dx_and_weight_grads_match_interpret_kernel(self, dtype, tol):
        """The plain backward against ``jax.grad`` through the interpret
        kernel (K2 with the causal flag): fp32 within 1e-4 of the gradient
        scale; bf16 within one bf16 rounding of an intermediate."""
        jax_p, torch_p, x, mask = both(11)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        dy = np.random.default_rng(12).normal(size=(B, S, H)) \
            .astype(np.float32)

        def loss(p, xx):
            y = jax_fel.fused_encoder_layer(p, xx, jnp.asarray(mask),
                                            num_heads=N, interpret=True,
                                            causal=True)
            return jnp.sum(y.astype(jnp.float32) * dy)

        gp, gx = jax.grad(loss, argnums=(0, 1))(
            jax_p, jnp.asarray(x).astype(jdt))
        for leaf in flatten(torch_p).values():
            leaf.requires_grad_(True)
        xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
        y = fel.fused_encoder_layer(torch_p, xt, torch.from_numpy(mask),
                                    num_heads=N, causal=True)
        (y.float() * torch.from_numpy(dy)).sum().backward()
        assert _rel_err(xt.grad.float().numpy(),
                        np.asarray(gx, np.float32)) <= tol
        gflat, ours = flatten(gp), flatten(torch_p)
        for path in _JAX_PATHS.values():
            assert _rel_err(ours[path].grad.numpy(),
                            np.asarray(gflat[path])) <= tol, path


class TestCausalLaws:

    def test_all_pad_row_is_uniform_over_its_visible_keys(self):
        """pad_bias + causal_bias: a row that sees only padding scores -1e9
        on keys j <= i and -2e9 after, so it is uniform over j <= i (what
        the TPU kernel computes), not over all S keys."""
        _, torch_p, x, mask = both(3)
        r = fel._forward_math(fel.flat_weights(torch_p), torch.from_numpy(x),
                              torch.from_numpy(mask), N, 0, 0.0, 0.0,
                              causal=True)
        p = r["p"][ALL_PAD]                                    # [N, S, S]
        tri = torch.tril(torch.ones(S, S))
        want = tri / tri.sum(-1, keepdim=True)
        assert torch.allclose(p, want.expand_as(p), atol=1e-7)
        # an unpadded row puts no mass after the diagonal
        assert float((r["p"][0] * (1 - tri)).abs().max()) == 0.0

    @pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
    def test_outputs_up_to_i_ignore_later_tokens(self, fused):
        """As tests/models_tests/test_sasrec.py's future-independence law:
        changing the tokens at positions >= 10 leaves the encoder outputs
        at positions < 10 unchanged, on both routes."""
        cfg = BERT4RecConfig(vocab_size=43, hidden_size=H, num_layers=2,
                             num_attention_heads=N, inner_dim=F,
                             max_sequence_length=S, causal_attention=True,
                             use_fused_layer=fused)
        enc = Bert4RecEncoder(cfg)
        assert enc.fused_layer_routed(2, S) == fused
        params = enc.init(torch.Generator().manual_seed(0), device="cpu")
        rng = np.random.default_rng(0)
        ids = rng.integers(3, 43, size=(2, S)).astype(np.int32)
        mask = np.ones((2, S), np.int32)
        out1 = enc.apply(params, torch.from_numpy(ids),
                         torch.from_numpy(mask))["sequence_output"]
        ids2 = ids.copy()
        ids2[:, 10:] = (ids2[:, 10:] + 7 - 3) % 40 + 3
        out2 = enc.apply(params, torch.from_numpy(ids2),
                         torch.from_numpy(mask))["sequence_output"]
        np.testing.assert_allclose(out1[:, :10].numpy(),
                                   out2[:, :10].numpy(), atol=1e-5,
                                   rtol=1e-5)
        assert float((out1[:, 10:] - out2[:, 10:]).abs().max()) > 1e-3

    def test_gradcheck_float64(self):
        """Analytic gradients of the causal autograd Function (plain
        forward and backward) against finite differences, dropout on."""
        rng = np.random.default_rng(31)
        b, s, h, n, f = 2, 5, 8, 2, 12
        flat = {k: torch.from_numpy(v.astype(np.float64))
                for k, v in fel.flat_weights(
                    unflatten(flatten(layer_params_np(rng, h, n, f)))).items()}
        x, mask = inputs_np(rng, b, s, h)
        xt = torch.from_numpy(x.astype(np.float64)).requires_grad_(True)
        mt = torch.from_numpy(mask)
        ops = [flat[k].clone().requires_grad_(True) for k in fel._W_ORDER]

        def fn(xx, *w):
            return fel._FusedLayer.apply(xx, mt, 5, n, 0.2, 0.5, True, *w)

        assert torch.autograd.gradcheck(fn, (xt, *ops), eps=1e-6,
                                        atol=1e-5, rtol=1e-4)


class TestUnfusedCausalBlockVersusJax:

    @pytest.mark.parametrize("pad_row", [False, True],
                             ids=["padded", "all_pad_row"])
    def test_encoder_matches_jax_unfused(self, pad_row):
        """The unfused route (the triangle folded into the block's bias)
        against JAX's encoder with ``use_fused_layer=False``, fp32."""
        kw = dict(vocab_size=43, hidden_size=H, num_layers=2,
                  num_attention_heads=N, inner_dim=F, max_sequence_length=S,
                  causal_attention=True, use_fused_layer=False)
        jenc = JaxEncoder(JaxConfig(**kw))
        shapes = flatten(jenc.init(jax.random.key(0)))
        rng = np.random.default_rng(5)
        flat = {k: (1.0 + 0.1 * rng.normal(size=v.shape) if
                    k.endswith("/scale") else 0.1 * rng.normal(size=v.shape))
                .astype(np.float32) for k, v in shapes.items()}
        ids = rng.integers(3, 43, size=(B, S)).astype(np.int32)
        _, mask = inputs_np(rng, B, S, H)
        if pad_row:
            mask[1] = 0
        ids = ids * mask
        ref = jenc.apply(unflatten({k: jnp.asarray(v)
                                    for k, v in flat.items()}),
                         jnp.asarray(ids), jnp.asarray(mask))
        enc = Bert4RecEncoder(BERT4RecConfig(**kw))
        out = enc.apply(params_from_numpy(flat, "cpu"), torch.from_numpy(ids),
                        torch.from_numpy(mask))
        np.testing.assert_allclose(out["sequence_output"].numpy(),
                                   np.asarray(ref["sequence_output"]),
                                   rtol=1e-4, atol=1e-4)


class TestThreeTf32Causal:
    """K2 causal's 3xTF32 law (csrc/layer_tf32.cu), emulated on the CPU:
    within 3e-4 of the gradients' scale of ``jax.grad`` through the
    interpret kernel at rate 0 (one TF32 pass at least 10x further off),
    and within 1e-5 of the plain fp32 backward with dropout."""

    def test_backward_in_3xtf32_matches_interpret_kernel(self):
        err3, err1 = backward_3xtf32_errs(causal=True)
        assert err3 <= 3e-4, err3
        assert err1 >= 10 * err3, (err3, err1)

    def test_backward_in_3xtf32_with_dropout_matches_plain(self):
        assert dropout_3xtf32_err(causal=True) <= 1e-5
