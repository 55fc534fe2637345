"""The port's fused encoder layer (bert4rec_tpu_torch/ops/fused_encoder_layer.py)
held against the JAX package's Pallas kernel, run in interpret mode on the
CPU: the forward, and the backward's dx and 12 weight gradients at rate 0.
Dropout, which JAX cannot run on the CPU (interpret mode stubs its PRNG),
is held by its own laws: the keep rate, the plain backward against
autograd through the plain forward with the same masks, and gradcheck.
The CUDA kernels themselves are held against the plain versions on a card
in tests/test_torch_cuda_kernels.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4rec_tpu.ops import fused_encoder_layer as jax_fel
from bert4rec_tpu_torch.ops import dropout_bits
from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
from bert4rec_tpu_torch.ops import tf32
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
        dict(rel_bias=torch.from_numpy(np.random.default_rng(0).normal(
            size=(B, N, S, S)).astype(np.float32))),
        dict(attention_dropout=0.2),
        dict(output_dropout=0.5),
    ], ids=["causal", "rel_bias", "attention_dropout", "output_dropout"])
    def test_unported_variants_raise(self, kwargs):
        """Every variant is ported, the relative bias too: each
        runs, moves the output off the bidirectional rate-0 output and
        repeats under one seed."""
        _, torch_p, x, mask = both(0)
        xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
        out = fel.fused_encoder_layer(torch_p, xt, mt, num_heads=N, seed=7,
                                      **kwargs)
        again = fel.fused_encoder_layer(torch_p, xt, mt, num_heads=N,
                                        seed=7, **kwargs)
        base = fel.fused_encoder_layer(torch_p, xt, mt, num_heads=N)
        assert torch.isfinite(out).all() and torch.equal(out, again)
        assert float((out - base).abs().max()) > 1e-2

    def test_rejects_non_int32_mask(self):
        _, torch_p, x, mask = both(0)
        with pytest.raises(ValueError):
            fel.fused_encoder_layer(torch_p, torch.from_numpy(x),
                                    torch.from_numpy(mask).long(),
                                    num_heads=N)


# (B, H, N, F), the forward's launch arguments, the route
ROUTE_CASES = [
    # what the server and the evaluator run: fp32, nothing saved, rate 0
    ((32, 128, 4, 512), {}, "tf32"),              # ml-1m_128, B=32
    ((256, 128, 4, 512), {}, "tf32"),             # recommend_stream
    ((256, 256, 8, 1024), {}, "tf32"),            # ml-20m_256
    ((2, 256, 4, 512), {}, "tf32"),               # head dim 64
    ((2, 64, 8, 128), {}, "tf32"),                # head dim 8
    # training: the forward saves for the 3xTF32 backward
    ((256, 128, 4, 512), dict(save=True), "tf32"),
    # dropout drawn: the 3xTF32 kernels hash it
    ((256, 128, 4, 512), dict(attn_rate=0.1), "tf32"),
    ((256, 128, 4, 512), dict(out_rate=0.1), "tf32"),
    # the temporal gate's layer, H=256, causal and with a relative bias
    ((128, 64, 4, 128), dict(save=True, attn_rate=0.1, out_rate=0.1),
     "tf32"),
    ((256, 256, 8, 1024), dict(save=True, attn_rate=0.1, out_rate=0.1),
     "tf32"),
    ((256, 128, 4, 512), dict(save=True, causal=True), "tf32"),
    ((256, 128, 4, 512), dict(save=True, rel=True, attn_rate=0.1), "tf32"),
    # past the 3xTF32 kernels' shapes
    ((2, 512, 4, 96), {}, "simt"),                # hidden 512
    ((2, 256, 2, 64), {}, "simt"),                # head dim 128
    ((3, 36, 4, 72), {}, "simt"),                 # head dim 9
    ((2, 96, 4, 100), {}, "simt"),                # inner 100
    ((2, 512, 4, 96), dict(save=True, attn_rate=0.1), "simt"),
    # bf16 takes its own route whatever is saved
    ((256, 128, 4, 512), {}, "wgmma"),
    ((256, 128, 4, 512), dict(save=True, attn_rate=0.1), "wgmma"),
]


class TestKernelRoute:
    """The shape law that sends a CUDA launch to its kernels, decided in
    Python before any launch (so it is tested here, without a card)."""

    @pytest.mark.parametrize("shape, dtype, route", [
        # every layer config the repo trains: bf16 on the wgmma kernels
        ((256, 128, 4, 512), torch.bfloat16, "wgmma"),    # ml-1m / ml-20m_128
        ((256, 256, 8, 1024), torch.bfloat16, "wgmma"),   # ml-20m_256
        ((2, 64, 4, 128), torch.bfloat16, "wgmma"),       # head dim 16
        ((2, 256, 2, 512), torch.bfloat16, "wgmma"),      # head dim 128
        ((2, 512, 4, 96), torch.bfloat16, "wgmma"),       # the widest hidden
        ((4, 32, 4, 64), torch.bfloat16, "wgmma"),        # head dim 8
        # a hidden, head dim or inner dim off the 16-byte copies: mma.sync
        ((3, 36, 4, 72), torch.bfloat16, "mma_sync"),     # head dim 9
        ((2, 100, 4, 200), torch.bfloat16, "mma_sync"),   # hidden 100
        ((2, 96, 4, 100), torch.bfloat16, "mma_sync"),    # inner 100
        ((2, 96, 8, 64), torch.bfloat16, "mma_sync"),     # head dim 12
        # fp32 inside the 3xTF32 rule on the 3xTF32 kernels, off it SIMT
        ((256, 128, 4, 512), torch.float32, "tf32"),
        ((3, 36, 4, 72), torch.float32, "simt"),
        ((128, 64, 4, 128), torch.float32, "tf32"),       # the temporal gate
        ((256, 256, 8, 1024), torch.float32, "tf32"),     # H=256
    ], ids=lambda v: str(v).replace("torch.", "").replace(" ", ""))
    def test_route(self, shape, dtype, route):
        b, h, n, f = shape
        assert fel.kernel_route(dtype, b, h, n, f) == route

    @pytest.mark.parametrize("shape", [
        (2, 520, 4, 64), (2, 256, 1, 64), (65536, 128, 4, 512),
    ], ids=["hidden_520", "head_dim_256", "batch_65536"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["fp32", "bf16"])
    def test_beyond_every_kernel_raises(self, shape, dtype):
        b, h, n, f = shape
        with pytest.raises(ValueError):
            fel.kernel_route(dtype, b, h, n, f)

    def test_other_dtypes_raise(self):
        with pytest.raises(ValueError):
            fel.kernel_route(torch.float16, 2, 128, 4, 512)

    @pytest.mark.parametrize("shape, launch, route", ROUTE_CASES,
                             ids=lambda v: str(v).replace(" ", ""))
    def test_fp32_inference_route(self, shape, launch, route):
        """Every fp32 launch inside the 3xTF32 rule runs the 3xTF32
        kernels: the forward that saves nothing and draws no dropout (the
        encoder's rates outside training are exactly 0), the training
        forward, dropout, causal and with a relative bias; the law reads
        the dtype and shape alone (``launch`` is what the forward is
        called with, which ``test_backward_takes_the_forward_route`` passes
        to the wrapper), and shapes past the kernels stay SIMT."""
        b, h, n, f = shape
        dtype = torch.bfloat16 if route == "wgmma" else torch.float32
        assert fel.kernel_route(dtype, b, h, n, f) == route

    @pytest.mark.parametrize("shape, launch, route", ROUTE_CASES,
                             ids=lambda v: str(v).replace(" ", ""))
    def test_backward_takes_the_forward_route(self, shape, launch, route,
                                              monkeypatch):
        """The wrapper's forward with ``launch``'s arguments (saving for a
        backward) and its backward, which gets no save flag, pick the same
        route: every route taken is recorded, and the kernel library is
        stubbed to stop each launch before it reaches the card."""
        b, h, n, f = shape
        dtype = torch.bfloat16 if route == "wgmma" else torch.float32
        seen, real = [], fel.kernel_route

        def spy(*args):
            seen.append(real(*args))
            return seen[-1]

        class Stop(Exception):
            pass

        def stop():
            raise Stop

        monkeypatch.setattr(fel, "kernel_route", spy)
        monkeypatch.setattr(fel, "_kernel_lib", stop)
        monkeypatch.setattr(fel, "_kernel_lib_tf32", stop)
        flat = {k: torch.zeros(v.shape) for k, v in fel.flat_weights(
            params_from_numpy(flatten(layer_params_np(
                np.random.default_rng(0), h, n, f)), "cpu")).items()}
        x = torch.zeros((b, 2, h), dtype=dtype)
        mask = torch.ones((b, 2), dtype=torch.int32)
        causal = launch.get("causal", False)
        rel = torch.zeros((b, n, 2, 2)) if launch.get("rel") else None
        rates = (launch.get("attn_rate", 0.0), launch.get("out_rate", 0.0))
        with pytest.raises(Stop):
            fel._launch_forward(flat, x, mask, n, 7, *rates,
                                launch.get("save", True), causal, rel)
        with pytest.raises(Stop):
            fel._launch_backward(flat, x, mask, x, (), n, 7, *rates,
                                 causal, rel)
        assert seen == [route, route]

    def test_the_encoder_passes_rate_zero_outside_training(self):
        """The route's condition is what the encoder passes at inference:
        ``apply(training=False)`` calls the layer with both rates exactly
        0.0 whatever the config's rates, and under ``no_grad`` nothing is
        saved."""
        from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
        cfg = BERT4RecConfig(vocab_size=40, max_sequence_length=S,
                             hidden_size=H, num_attention_heads=N,
                             num_layers=2, inner_dim=F, use_fused_layer=True,
                             attention_dropout=0.2, output_dropout=0.5)
        model = BERT4RecModel(config=cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        seen = []

        def spy(p, x, mask, **kw):
            seen.append((kw["attention_dropout"], kw["output_dropout"],
                         torch.is_grad_enabled()))
            return fel.fused_encoder_layer_plain(p, x, mask,
                                                 num_heads=kw["num_heads"])

        ids = torch.randint(3, 40, (B, S))
        mask = torch.ones((B, S), dtype=torch.int32)
        from unittest import mock
        from bert4rec_tpu_torch.models.components.networks import \
            bert4rec_encoder
        with mock.patch.object(bert4rec_encoder, "fused_encoder_layer", spy), \
                torch.no_grad():
            model.encoder.apply(params["encoder"], ids, mask, training=False)
        assert seen == [(0.0, 0.0, False)] * 2

    @pytest.mark.parametrize("s, tiles", [(1, 1), (64, 1), (65, 2), (200, 4)])
    def test_keep_bits_match_the_plain_packing(self, s, tiles):
        """The wgmma forward's saved keep bits have the shape of
        dropout_bits.tile_keep_bits, their plain packing."""
        assert fel.keep_bits_shape(3, 2, s) == (3, 2, tiles, tiles, 128)
        bits = dropout_bits.tile_keep_bits(7, 3, 2, s, 0.1, "cpu")
        assert tuple(bits.shape) == fel.keep_bits_shape(3, 2, s)


def _layer_with(mm, flat, x, mask, n):
    """The fused layer's forward at rate 0 (``_layer_fwd_math``) with every
    product — qkv, q k^T, p v, Wo, W1, W2 — taken by ``mm``."""
    b, s, h = x.shape
    d = h // n
    w = {k: v.float() for k, v in flat.items()}
    qkv = mm(x.reshape(-1, h), w["wqkv"]) + w["bqkv"]
    q, k, v = (t.reshape(b, s, n, d).transpose(1, 2)
               for t in qkv.split(h, dim=-1))
    bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None]
    scores = mm(q, k.transpose(-1, -2)) * (1.0 / d ** 0.5) + bias
    p = torch.softmax(scores, dim=-1)
    ctx = mm(p, v).transpose(1, 2).reshape(b * s, h)
    x1 = fel._ln_fwd(x.reshape(-1, h) + (mm(ctx, w["wo"]) + w["bo"]),
                     w["g1"], w["b1ln"])[0]
    hact = fel._gelu_tanh(mm(x1, w["w1"]) + w["bf1"])
    y = fel._ln_fwd(x1 + (mm(hact, w["w2"]) + w["bf2"]), w["g2"],
                    w["b2ln"])[0]
    return y.reshape(b, s, h)


class TestThreeTf32:
    """The rounding law of the fp32 layer kernels (csrc/layer_tf32.cu),
    emulated here on the CPU before any card time: each product in 3xTF32
    keeps the layer's forward within 1e-4 of the JAX fp32 kernel and its
    backward within 3e-4 of the gradients' scale; one pass of TF32 is an
    order of magnitude further off."""

    @pytest.mark.parametrize("v", [1.0, -1.0, 1.0 + 2.0 ** -11,
                                   -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -12,
                                   3.0e-39, 1.7e38])
    def test_split_rounds_as_cvt_rna(self, v):
        """The emulated split is cvt.rna's law, held against rounding in
        float64 to 11 significant bits: ties away from zero (1 + 2^-11 lies
        halfway between two TF32 values), subnormals (a fixed step of
        2^-136) and the top of the range; hi + lo is a normal value to
        2^-21 of it."""
        t = torch.tensor([v], dtype=torch.float32)
        x = float(t)
        step = 2.0 ** (max(math.frexp(x)[1], -125) - 11)
        want = math.copysign(math.floor(abs(x) / step + 0.5) * step, x)
        hi = tf32.rna_tf32(t)
        lo = tf32.rna_tf32(t - hi)
        assert float(hi) == want
        if v == 1.0 + 2.0 ** -11:
            assert float(hi) == 1.0 + 2.0 ** -10
        if abs(v) >= 2.0 ** -126:   # normal: lo carries 11 more bits
            assert abs(float(hi) + float(lo) - float(t)) <= \
                2.0 ** -21 * abs(v)

    def test_product_error(self):
        """3xTF32 products stay within a few fp32 ulps of the float64
        product; one TF32 pass is ~2^-11 off."""
        rng = np.random.default_rng(5)
        a = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(128, 96)).astype(np.float32))
        exact = a.double() @ b.double()
        scale = float(exact.abs().max())
        err3 = float((tf32.mm_3xtf32(a, b).double() - exact).abs().max()) \
            / scale
        err1 = float((tf32.mm_tf32(a, b).double() - exact).abs().max()) \
            / scale
        assert err3 < 2e-6 and err1 > 50 * err3

    @pytest.mark.parametrize("seed", [0, 1])
    def test_layer_in_3xtf32_matches_interpret_kernel(self, seed):
        jax_p, torch_p, x, mask = both(seed)
        ref = np.asarray(jax_fel.fused_encoder_layer(
            jax_p, jnp.asarray(x), jnp.asarray(mask), num_heads=N,
            interpret=True))
        flat = fel.flat_weights(torch_p)
        xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
        got3 = _layer_with(tf32.mm_3xtf32, flat, xt, mt, N).numpy()
        got1 = _layer_with(tf32.mm_tf32, flat, xt, mt, N).numpy()
        err3 = float(np.abs(got3 - ref).max())
        err1 = float(np.abs(got1 - ref).max())
        assert err3 <= 1e-4, err3
        assert err1 > 10 * err3

    # the backward's law (csrc/layer_tf32.cu's K2: every product, the
    # forward's recomputed ones too, in 3xTF32); the causal and relative-
    # bias variants' cases are in test_torch_causal_layer.py and
    # test_torch_temporal.py
    def test_backward_in_3xtf32_matches_interpret_kernel(self):
        """At rate 0 the plain backward with every product in 3xTF32
        stays within 3e-4 of the gradients' scale (the loss kernels'
        bound) of ``jax.grad`` through the interpret kernel, for dx and the
        12 weight gradients; one pass of TF32 is at least 10x further
        off."""
        err3, err1 = backward_3xtf32_errs()
        assert err3 <= 3e-4, err3
        assert err1 >= 10 * err3, (err3, err1)

    def test_backward_in_3xtf32_with_dropout_matches_plain(self):
        """With dropout (0.2 / 0.5, one seed, so the same masks) the
        3xTF32 backward stays within 1e-5 of the gradients' scale of the
        plain fp32 backward: dx and the 12 weight gradients."""
        assert dropout_3xtf32_err() <= 1e-5


def backward_3xtf32_errs(causal=False, rel=False):
    """``(err3, err1)``: the plain backward at rate 0 with every product in
    3xTF32 (``tf32.mm_3xtf32``) and in one TF32 pass, each against
    ``jax.grad`` through JAX's interpret kernel, as the largest
    ``_rel_err`` over dx, the 12 weight gradients and (``rel``) dRel;
    CPU-small: B=2, S=16."""
    rng = np.random.default_rng(41 + 2 * causal + rel)
    b, s = 2, 16
    flat_np = flatten(layer_params_np(rng, H, N, F))
    x, mask = inputs_np(rng, b, s, H)
    dy = rng.normal(size=(b, s, H)).astype(np.float32)
    bias = rng.normal(size=(b, N, s, s)).astype(np.float32) if rel else None
    jax_p = unflatten({k: jnp.asarray(v) for k, v in flat_np.items()})

    def loss(p, xx, rr=None):
        y = jax_fel.fused_encoder_layer(p, xx, jnp.asarray(mask),
                                        num_heads=N, interpret=True,
                                        causal=causal, rel_bias=rr)
        return jnp.sum(y * dy)

    args = (jax_p, jnp.asarray(x)) + (() if bias is None
                                      else (jnp.asarray(bias),))
    ref = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    want = {"dx": np.asarray(ref[1]),
            **{k: np.asarray(flatten(ref[0])[path])
               for k, path in _JAX_PATHS.items()}}
    if bias is not None:
        want["rel"] = np.asarray(ref[2])
    flat = fel.flat_weights(params_from_numpy(flat_np, "cpu"))
    errs = []
    for mm in (tf32.mm_3xtf32, tf32.mm_tf32):
        dx, grads = fel.fused_encoder_layer_plain_backward(
            flat, torch.from_numpy(x), torch.from_numpy(mask),
            torch.from_numpy(dy), num_heads=N, causal=causal,
            rel_bias=None if bias is None else torch.from_numpy(bias), mm=mm)
        got = {"dx": dx.numpy(), **{k: g.numpy().reshape(want[k].shape)
                                    for k, g in grads.items()}}
        errs.append(max(_rel_err(got[k], want[k]) for k in want))
    return tuple(errs)


def dropout_3xtf32_err(causal=False, rel=False):
    """The largest ``_rel_err`` of the 3xTF32 plain backward against the
    fp32 one, dropout 0.2 / 0.5 under one seed (the same masks): dx, the
    12 weight gradients and (``rel``) dRel; B=2, S=16."""
    rng = np.random.default_rng(51 + 2 * causal + rel)
    b, s = 2, 16
    flat = fel.flat_weights(params_from_numpy(
        flatten(layer_params_np(rng, H, N, F)), "cpu"))
    x, mask = inputs_np(rng, b, s, H)
    dy = torch.from_numpy(rng.normal(size=(b, s, H)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(b, N, s, s)).astype(np.float32)) \
        if rel else None
    kw = dict(num_heads=N, attention_dropout=0.2, output_dropout=0.5,
              seed=97, causal=causal, rel_bias=bias)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    dx3, g3 = fel.fused_encoder_layer_plain_backward(
        flat, xt, mt, dy, mm=tf32.mm_3xtf32, **kw)
    dx, g = fel.fused_encoder_layer_plain_backward(flat, xt, mt, dy, **kw)
    assert set(g3) == set(g) and (("rel" in g) == rel)
    return max([_rel_err(dx3.numpy(), dx.numpy())]
               + [_rel_err(g3[k].numpy(), g[k].numpy()) for k in g])


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


def _rel_err(a, b) -> float:
    """max |a - b| over max |b|: gradients sum over every row."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


_JAX_PATHS = dict(zip(fel._W_ORDER, [
    "attention/qkv/kernel", "attention/qkv/bias", "attention/output/kernel",
    "attention/output/bias", "attention_norm/scale", "attention_norm/bias",
    "intermediate/kernel", "intermediate/bias", "output/kernel",
    "output/bias", "output_norm/scale", "output_norm/bias"]))


class TestBackwardVersusJaxKernel:
    """The plain backward (mirroring ``_bwd_element``) at rate 0 against
    ``jax.grad`` through ``fused_encoder_layer(..., interpret=True)``, whose
    custom VJP runs the backward Pallas kernel K2."""

    # fp32: the same math in another summation order; bf16: an order
    # difference can flip the bf16 rounding of an intermediate (ds, dhpre,
    # dattn), one bf16 ulp (2^-8 relative) of that intermediate
    @pytest.mark.parametrize("dtype,tol", [
        (torch.float32, 1e-5), (torch.bfloat16, 5e-3)], ids=["fp32", "bf16"])
    def test_dx_and_weight_grads_match_interpret_kernel(self, dtype, tol):
        jax_p, torch_p, x, mask = both(11)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        dy = np.random.default_rng(12).normal(size=(B, S, H)) \
            .astype(np.float32)

        def loss(p, xx):
            y = jax_fel.fused_encoder_layer(p, xx, jnp.asarray(mask),
                                            num_heads=N, interpret=True)
            return jnp.sum(y.astype(jnp.float32) * dy)

        gp, gx = jax.grad(loss, argnums=(0, 1))(
            jax_p, jnp.asarray(x).astype(jdt))
        for leaf in flatten(torch_p).values():
            leaf.requires_grad_(True)
        xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
        y = fel.fused_encoder_layer(torch_p, xt, torch.from_numpy(mask),
                                    num_heads=N)
        (y.float() * torch.from_numpy(dy)).sum().backward()
        assert xt.grad.dtype == dtype
        assert _rel_err(xt.grad.float().numpy(),
                        np.asarray(gx, np.float32)) <= tol
        gflat, ours = flatten(gp), flatten(torch_p)
        for path in _JAX_PATHS.values():
            assert ours[path].grad.shape == ours[path].shape
            assert _rel_err(ours[path].grad.numpy(),
                            np.asarray(gflat[path])) <= tol, path


class TestDropout:

    @pytest.mark.parametrize("rate", [0.2, 0.5])
    def test_keep_rate_and_scale(self, rate):
        keep1, keep2, keep3 = fel.dropout_keeps(3, 8, 50, 64, 4, rate, rate,
                                                "cpu")
        for k in (keep1, keep2, keep3):
            kept = (k > 0).float()
            assert abs(float(kept.mean()) - (1 - rate)) < 1e-2
            assert set(torch.unique(k).tolist()) == {
                0.0, float(np.float32(1 / (1 - rate)))}
        # the two output sites and the heads draw different masks
        assert not torch.equal(keep2, keep3)
        assert not torch.equal(keep1[:, 0], keep1[:, 1])

    def test_hash_is_the_documented_law(self):
        """fmix32 matches murmur3's finaliser on known values, the int64
        arithmetic stays inside 32 bits, and the threshold law is
        uint32(rate * 2^32)."""
        def fmix(h):
            h ^= h >> 16
            h = (h * 0x85EBCA6B) & 0xFFFFFFFF
            h ^= h >> 13
            h = (h * 0xC2B2AE35) & 0xFFFFFFFF
            return h ^ (h >> 16)

        def law(key, ctr):
            k = fmix(key & 0xFFFFFFFF)
            return fmix(k ^ ((ctr * 0x9E3779B9) & 0xFFFFFFFF))

        keys = np.array([0, 1, 2 ** 31 - 1, 2 ** 32 - 1, 123456789])
        ctrs = np.array([0, 7, 39999, 2 ** 31, 2 ** 32 - 1])
        got = dropout_bits.bits(torch.from_numpy(keys)[:, None],
                                torch.from_numpy(ctrs)[None, :])
        want = [[law(int(k), int(c)) for c in ctrs] for k in keys]
        assert got.tolist() == want
        assert dropout_bits.threshold(0.2) == int(0.2 * 2 ** 32)
        assert dropout_bits.threshold(1.0) == 2 ** 32 - 1

    @pytest.mark.parametrize("rates", [(0.2, 0.0), (0.0, 0.5), (0.2, 0.5)],
                             ids=["attention", "output", "both"])
    def test_plain_backward_equals_autograd_with_the_same_masks(self, rates):
        """The hand-written backward regenerates the forward's masks from
        the seed: it equals autograd through the plain forward (fp32,
        where every rounding point is the identity)."""
        _, torch_p, x, mask = both(21)
        kw = dict(num_heads=N, attention_dropout=rates[0],
                  output_dropout=rates[1], seed=99)
        flat = fel.flat_weights(torch_p)
        xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
        dy = torch.from_numpy(np.random.default_rng(22)
                              .normal(size=(B, S, H)).astype(np.float32))
        dx, grads = fel.fused_encoder_layer_plain_backward(flat, xt, mt, dy,
                                                           **kw)
        leaves = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
        xg = xt.clone().requires_grad_(True)
        y = fel._forward_math(leaves, xg, mt, N, 99, *rates)["y"]
        auto = torch.autograd.grad(y, [xg, *leaves.values()], dy)
        # fp32 sums in another order; the masks must be equal for this
        # to hold at all (a differing mask moves grads by O(1))
        assert _rel_err(dx.numpy(), auto[0].numpy()) <= 1e-5
        for (k, _), g in zip(leaves.items(), auto[1:]):
            assert _rel_err(grads[k].numpy(), g.numpy()) <= 1e-5, k

    def test_gradcheck_float64(self):
        """Analytic gradients of the autograd Function (the plain forward
        and backward on the CPU) against finite differences, dropout on."""
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
            return fel._FusedLayer.apply(xx, mt, 5, n, 0.2, 0.5, False,
                                         *w)

        assert torch.autograd.gradcheck(fn, (xt, *ops), eps=1e-6,
                                        atol=1e-5, rtol=1e-4)
