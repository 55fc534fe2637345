"""The port's CUDA kernels held against their plain versions on the card.

Imports neither JAX nor ``bert4rec_tpu``, so it also runs on a machine
without them; there ``tests/conftest.py`` (which imports JAX) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Without a card every test here skips.
"""

import importlib

import numpy as np
import pytest
import torch

from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
from bert4rec_tpu_torch.utils.checkpoint import (flatten, params_from_numpy,
                                                 unflatten)


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
    (2, 130, 256, 2, 64), (1, 5, 512, 4, 96), (256, 200, 128, 4, 512),
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


# the 3xTF32 inference route (csrc/layer_tf32.cu): B 1, 32 and 256 at the
# serving shape, ml-20m_256's width, head dims 64, 16 and 24, S 1, 37, 65,
# 130 and 200 (keys on, one past and one short of the 64-key tiles)
TF32_DIMS = [(1, 200, 128, 4, 512), (32, 200, 128, 4, 512),
             (256, 200, 128, 4, 512), (3, 200, 256, 8, 1024),
             (3, 65, 256, 4, 512), (4, 1, 128, 4, 512), (4, 130, 64, 4, 128),
             (4, 37, 96, 4, 200)]


def _sees_a_real_key(mask, causal):
    """``[B, S]``: whether query s of sequence b attends to at least one
    real key (all of them, or those at or before it when causal)."""
    m = mask.bool()
    return m.cummax(dim=1).values if causal else m.any(dim=1, keepdim=True) \
        .expand_as(m)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", TF32_DIMS,
                         ids=lambda d: "B{}_S{}_H{}_N{}_F{}".format(*d))
@pytest.mark.parametrize("variant", ["plain", "causal", "rel", "causal_rel"])
def test_fp32_inference_route_matches_plain(cuda_device, dims, variant):
    """The fp32 forward without a gradient runs the 3xTF32 kernels (counted
    in tf32_launches) and stays within 1e-4 of the plain version, with an
    all-pad row, a row of length 1 and a front-padded row, causal and with a
    relative bias; two runs give the same bits. A query that sees only
    padding scores -1e9 + s for every key, where fp32's spacing is 64: which
    keys win there turns on the last bits of s whenever |s| nears 32 (as
    here at H = 256), for any two sums of s in different orders, so those
    rows are held to be finite here and to the plain version in
    test_fp32_inference_route_padding_only_rows, at scores well inside 32."""
    b, s, h, n, f = dims
    rng = np.random.default_rng(sum(dims) + len(variant))
    p = params_from_numpy(flatten(layer_params_np(rng, h, n, f)),
                          cuda_device)
    mt = torch.from_numpy(causal_mask_np(rng, b, s)).to(cuda_device)
    xt = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)) \
        .to(cuda_device)
    kw = dict(num_heads=n, causal="causal" in variant)
    if "rel" in variant:
        kw["rel_bias"] = torch.from_numpy(rng.normal(size=(b, n, s, s))
                                          .astype(np.float32)).to(cuda_device)
    assert fel.kernel_route(torch.float32, b, h, n, f) == "tf32"
    before = fel.fused_encoder_layer.tf32_launches
    with torch.no_grad():
        runs = [fel.fused_encoder_layer(p, xt, mt, **kw) for _ in range(2)]
        ref = fel.fused_encoder_layer_plain(p, xt, mt, **kw)
    torch.cuda.synchronize()
    assert fel.fused_encoder_layer.tf32_launches == before + 2
    assert runs[0].dtype == torch.float32 and runs[0].shape == xt.shape
    seen = _sees_a_real_key(mt, kw["causal"])
    assert bool(torch.isfinite(runs[0]).all())
    np.testing.assert_allclose(runs[0][seen].cpu().numpy(),
                               ref[seen].cpu().numpy(), rtol=0, atol=1e-4)
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional",
                                                       "causal"])
def test_fp32_inference_route_padding_only_rows(cuda_device, causal):
    """Queries that see only padding attend uniformly to their keys, as the
    TPU kernel's -1e9 bias makes them (not NaN, as -inf would): with inputs
    small enough that every score stays well inside 32, the 3xTF32 route
    equals the plain version within 1e-4 on every row, the all-pad row and
    the front-padded row's early queries among them."""
    b, s, h, n, f = 5, 130, 256, 8, 1024
    rng = np.random.default_rng(17)
    p = params_from_numpy(flatten(layer_params_np(rng, h, n, f)),
                          cuda_device)
    mt = torch.from_numpy(causal_mask_np(rng, b, s)).to(cuda_device)
    xt = torch.from_numpy((0.05 * rng.normal(size=(b, s, h)))
                          .astype(np.float32)).to(cuda_device)
    with torch.no_grad():
        y = fel.fused_encoder_layer(p, xt, mt, num_heads=n, causal=causal)
        ref = fel.fused_encoder_layer_plain(p, xt, mt, num_heads=n,
                                            causal=causal)
    assert not bool(_sees_a_real_key(mt, causal).all())
    np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
def test_fp32_training_forward_stays_on_the_simt_kernels(cuda_device):
    """A forward that saves for a backward, or draws dropout, no longer
    stays on the SIMT kernels: both count in tf32_launches, and the
    backward in tf32_backward_launches."""
    rng = np.random.default_rng(3)
    p = params_from_numpy(flatten(layer_params_np(rng, 128, 4, 512)),
                          cuda_device)
    x, mask = inputs_np(rng, 2, 40, 128)
    xt = torch.from_numpy(x).to(cuda_device)
    mt = torch.from_numpy(mask).to(cuda_device)
    f_ = fel.fused_encoder_layer
    before = (f_.tf32_launches, f_.tf32_backward_launches)
    y = fel.fused_encoder_layer(p, xt.requires_grad_(True), mt, num_heads=4)
    y.sum().backward()
    with torch.no_grad():
        fel.fused_encoder_layer(p, xt, mt, num_heads=4,
                                attention_dropout=0.1, seed=3)
    torch.cuda.synchronize()
    assert (f_.tf32_launches, f_.tf32_backward_launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("write", ["foreach_add", "data_copy", "new_tensor"])
def test_fp32_inference_route_reads_the_weights_as_they_are(cuda_device,
                                                           write):
    """The 3xTF32 route transposes and splits the weights in every launch:
    after an optimizer's in-place step (``torch._foreach_add_``, as the
    port's optimizer writes), a write through ``.data`` (which moves no
    version counter) or new weight tensors at the old ones' addresses, the
    next inference launch equals the plain layer on the new weights within
    1e-4, as in a train-then-evaluate loop."""
    rng = np.random.default_rng(11)
    p = params_from_numpy(flatten(layer_params_np(rng, 128, 4, 512)),
                          cuda_device)
    x, mask = inputs_np(rng, 8, 200, 128)
    xt = torch.from_numpy(x).to(cuda_device)
    mt = torch.from_numpy(mask).to(cuda_device)
    leaves = flatten(p)
    steps = {k: torch.from_numpy(0.05 * rng.normal(size=tuple(t.shape))
                                 .astype(np.float32)).to(cuda_device)
             for k, t in leaves.items()}
    with torch.no_grad():
        first = fel.fused_encoder_layer(p, xt, mt, num_heads=4)
        if write == "foreach_add":
            torch._foreach_add_(list(leaves.values()), list(steps.values()))
        elif write == "data_copy":
            for k, t in leaves.items():
                t.data.copy_(t.data + steps[k])
        else:   # fresh tensors, at the freed ones' addresses if it can
            new = {k: (t + steps[k]).cpu() for k, t in leaves.items()}
            del p, leaves
            p = unflatten({k: v.to(cuda_device) for k, v in new.items()})
        y = fel.fused_encoder_layer(p, xt, mt, num_heads=4)
        ref = fel.fused_encoder_layer_plain(p, xt, mt, num_heads=4)
    torch.cuda.synchronize()
    assert float((y - first).abs().max()) > 1e-2
    np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-4)


# --------------------------------------------------------------------------- #
# training: K1 with dropout, K2, and the fused loss K3 / K4
# --------------------------------------------------------------------------- #

def _rel_err(a, b):
    """max |a - b| over max |b|: gradients are held relative to their
    scale, since they sum over every row of the batch."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)


# fp32: the same math in another summation order; bf16: a sum-order
# difference can flip the bf16 rounding of an intermediate (ds, dhpre,
# dattn), which moves a gradient by up to a few bf16 ulps of its scale
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the layer's weights in the JAX layout, in ``fel._W_ORDER``'s order
_NAMES = ("attention/qkv/kernel", "attention/qkv/bias",
          "attention/output/kernel", "attention/output/bias",
          "attention_norm/scale", "attention_norm/bias",
          "intermediate/kernel", "intermediate/bias", "output/kernel",
          "output/bias", "output_norm/scale", "output_norm/bias")


def _backward_twice(flat, xt, mt, dy, n, seed, rates, **launch):
    """One forward launch saving for its backward, then two backward
    launches from its saves, which must give the same bits (dx and every
    gradient). Returns ``(y, (dx, grads))``."""
    y, saved = fel._launch_forward(flat, xt.detach(), mt, n, seed, *rates,
                                   True, **launch)
    runs = [fel._launch_backward(flat, xt.detach(), mt, dy, saved, n, seed,
                                 *rates, **launch) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
    return y, runs[0]


# the 3xTF32 training route's shapes besides ml-1m's: the temporal gate's
# layer (H=64, 4 heads, F=128) and ml-20m_256's width (H=256, 8 heads); the
# train batch (B=256) at ml-1m_128's width
@pytest.mark.cuda
@pytest.mark.parametrize("dims", [
    (4, 24, 32, 4, 64), (3, 200, 128, 4, 512), (2, 37, 96, 4, 200),
    (16, 50, 64, 4, 128), (3, 200, 256, 8, 1024), (256, 200, 128, 4, 512),
], ids=lambda d: "B{}_S{}_H{}_N{}_F{}".format(*d))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.2, 0.5)],
                         ids=["rate0", "dropout"])
def test_fused_layer_train_kernels_match_plain(cuda_device, dims, dtype,
                                               rates):
    b, s, h, n, f = dims
    rng = np.random.default_rng(sum(dims) + 7)
    p = params_from_numpy(flatten(layer_params_np(rng, h, n, f)),
                          cuda_device)
    for leaf in flatten(p).values():
        leaf.requires_grad_(True)
    x, mask = inputs_np(rng, b, s, h)
    xt = torch.from_numpy(x).to(cuda_device, dtype).requires_grad_(True)
    mt = torch.from_numpy(mask).to(cuda_device)
    dy = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)) \
        .to(cuda_device, dtype)
    kw = dict(num_heads=n, attention_dropout=rates[0],
              output_dropout=rates[1], seed=12345)
    fwd0, bwd0 = (fel.fused_encoder_layer.launches,
                  fel.fused_encoder_layer.backward_launches)
    y = fel.fused_encoder_layer(p, xt, mt, **kw)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (fel.fused_encoder_layer.launches,
            fel.fused_encoder_layer.backward_launches) == (fwd0 + 1, bwd0 + 1)
    with torch.no_grad():
        ref_y = fel.fused_encoder_layer_plain(p, xt, mt, **kw)
        flat = {k: v.detach() for k, v in fel.flat_weights(p).items()}
        ref_dx, ref_g = fel.fused_encoder_layer_plain_backward(
            flat, xt.detach(), mt, dy, **kw)
    tol = 1e-4 if dtype == torch.float32 else 8e-2
    np.testing.assert_allclose(y.detach().float().cpu().numpy(),
                               ref_y.float().cpu().numpy(), rtol=0, atol=tol)
    assert _rel_err(xt.grad, ref_dx) <= GRAD_TOL[dtype]
    got = {k: v.grad for k, v in flatten(p).items()}
    for k, path in zip(fel._W_ORDER, _NAMES):
        g = got[path].reshape(ref_g[k].shape)
        assert _rel_err(g, ref_g[k]) <= GRAD_TOL[dtype], path
    _backward_twice(flat, xt, mt, dy, n, 12345, rates)


@pytest.mark.cuda
def test_fused_layer_backward_is_deterministic(cuda_device):
    rng = np.random.default_rng(5)
    b, s, h, n, f = 4, 200, 128, 4, 512
    p = params_from_numpy(flatten(layer_params_np(rng, h, n, f)),
                          cuda_device)
    for leaf in flatten(p).values():
        leaf.requires_grad_(True)
    x, mask = inputs_np(rng, b, s, h)
    xt = torch.from_numpy(x).to(cuda_device, torch.bfloat16)
    mt = torch.from_numpy(mask).to(cuda_device)
    runs = []
    for _ in range(2):
        y = fel.fused_encoder_layer(p, xt, mt, num_heads=n,
                                    attention_dropout=0.2,
                                    output_dropout=0.5, seed=3)
        grads = torch.autograd.grad(y.float().square().sum(),
                                    list(flatten(p).values()))
        runs.append([g.clone() for g in grads])
    for a, c in zip(*runs):
        assert torch.equal(a, c)


# what an fp32 training launch may not reach: the SIMT layer kernels of
# csrc/fused_encoder_layer.cu and csrc/attention.cuh, forward and backward
SIMT_FP32_LAYER_KERNELS = (
    "gemm_kernel<float", "gemm_residual_ln_kernel<float",
    "attention_kernel<float", "attn_bwd_dq_kernel<float",
    "attn_bwd_dkv_kernel<float", "ln_bwd_kernel<float",
    "gelu_grad_gemm_kernel<float", "wgrad_kernel<float")
TF32_LAYER_KERNELS = (
    "wt_split_kernel", "w_split_kernel", "gemm_tf32_kernel<",
    "ln_tf32_kernel<", "ln_rows_bwd_kernel<", "attn_tf32_kernel<",
    "attn_dq_tf32_kernel<", "attn_dkv_tf32_kernel<", "wgrad_tf32_kernel",
    "colsum_kernel", "reduce_rows_kernel")


def _fp32_train_step(device, dims, rates=(0.1, 0.1), seed=9, causal=False,
                     rel=False, mask=None):
    """One fp32 forward with dropout and its backward through the wrapper:
    ``(run, p, xt, mt, dy, kw)``, ``run()`` returning ``(y, dx, grads)``."""
    b, s, h, n, f = dims
    rng = np.random.default_rng(sum(dims) + seed)
    p = params_from_numpy(flatten(layer_params_np(rng, h, n, f)), device)
    leaves = list(flatten(p).values())
    for leaf in leaves:
        leaf.requires_grad_(True)
    x, mk = inputs_np(rng, b, s, h)
    mt = torch.from_numpy(mk if mask is None else mask).to(device)
    xt = torch.from_numpy(x).to(device).requires_grad_(True)
    dy = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)) \
        .to(device)
    kw = dict(num_heads=n, attention_dropout=rates[0],
              output_dropout=rates[1], seed=seed, causal=causal)
    if rel:
        kw["rel_bias"] = torch.from_numpy(rng.normal(size=(b, n, s, s))
                                          .astype(np.float32)).to(device)

    def run():
        y = fel.fused_encoder_layer(p, xt, mt, **kw)
        grads = torch.autograd.grad(y, [xt, *leaves], dy)
        return y.detach(), grads[0], grads[1:]

    return run, p, xt, mt, dy, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(4, 200, 128, 4, 512),
                                  (3, 200, 256, 8, 1024)],
                         ids=["H128", "H256"])
def test_fp32_layer_backward_repeats_its_bits(cuda_device, dims):
    """Two fp32 training steps (dropout 0.1 / 0.1, one seed) give the same
    bits of y, dx and every weight gradient: no float atomics, the split
    partials summed in a fixed order."""
    run, *_ = _fp32_train_step(cuda_device, dims)
    a, c = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    assert all(torch.equal(g, h) for g, h in zip(a[2], c[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["bidirectional",
                                                       "causal"])
def test_fp32_training_padding_only_rows_stay_finite(cuda_device, causal):
    """A sequence of padding only, one of length 1 and a front-padded one
    (queries that see only padding score -1e9 + s): y, dx and every
    gradient of the 3xTF32 training route are finite, and with scores well
    inside 32 (small inputs) they match the plain version's."""
    dims = (5, 130, 128, 4, 512)
    mask = causal_mask_np(np.random.default_rng(4), dims[0], dims[1])
    run, p, xt, mt, dy, kw = _fp32_train_step(cuda_device, dims,
                                              causal=causal, mask=mask)
    with torch.no_grad():
        xt.mul_(0.05)
    y, dx, grads = run()
    torch.cuda.synchronize()
    assert not bool(_sees_a_real_key(mt, causal).all())
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(dx).all())
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        flat = {k: v.detach() for k, v in fel.flat_weights(p).items()}
        ref_y = fel.fused_encoder_layer_plain(p, xt, mt, **kw)
        ref_dx, _ = fel.fused_encoder_layer_plain_backward(
            flat, xt.detach(), mt, dy, **kw)
    np.testing.assert_allclose(y.cpu().numpy(), ref_y.cpu().numpy(), rtol=0,
                               atol=1e-4)
    assert _rel_err(dx, ref_dx) <= GRAD_TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["shifted_base", "column_slice"])
def test_fp32_training_takes_a_misaligned_operand_through_a_copy(
        cuda_device, case):
    """x and dy 4 bytes off a 16-byte boundary, or column slices of wider
    rows, go through the wrapper's copy: the 3xTF32 forward and backward
    give the bits of contiguous aligned operands."""
    dims = (3, 65, 128, 4, 512)
    run, p, xt, mt, dy, kw = _fp32_train_step(cuda_device, dims)
    flat = {k: v.detach() for k, v in fel.flat_weights(p).items()}
    x0 = xt.detach()
    y0, saved = fel._launch_forward(flat, x0, mt, 4, 9, 0.1, 0.1, True)
    want = fel._launch_backward(flat, x0, mt, dy, saved, 4, 9, 0.1, 0.1)

    def odd(t):
        if case == "shifted_base":
            buf = torch.zeros(t.numel() + 1, device=cuda_device)
            return buf[1:].view(t.shape).copy_(t)
        wide = torch.zeros((*t.shape[:-1], t.shape[-1] + 8),
                           device=cuda_device)
        wide[..., :t.shape[-1]] = t
        return wide[..., :t.shape[-1]]

    xo, dyo = odd(x0), odd(dy)
    assert (xo.data_ptr() % 16 and dyo.data_ptr() % 16) \
        if case == "shifted_base" else not xo.is_contiguous()
    y1, saved1 = fel._launch_forward(flat, xo, mt, 4, 9, 0.1, 0.1, True)
    got = fel._launch_backward(flat, xo, mt, dyo, saved1, 4, 9, 0.1, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(y1, y0) and torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])


def causal_mask_np(rng, b, s):
    """Row 0 unpadded, row 1 of length 1, row 2 all padding, row 3 padded
    at the front (its first key is padding, so no key tile is skipped while
    later real keys exist), the rest random right-padded lengths."""
    lengths = rng.integers(1, s + 1, size=b)
    lengths[:3] = [s, 1, 0][:min(3, b)]
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    if b > 3:
        mask[3] = (np.arange(s) >= s // 3).astype(np.int32)
    return mask


# S = 200 (the main path: 4 key tiles, the last ragged), 130 and 65 (one
# and two keys past a tile boundary), 64 (exactly one tile); the SASRec
# train batch (B=256); sasrec_example's layer (head dim 12: fp32 on SIMT)
CAUSAL_DIMS = [(5, 200, 128, 4, 512), (4, 130, 32, 4, 64),
               (4, 65, 96, 4, 200), (4, 64, 64, 2, 128),
               (256, 200, 128, 4, 512), (64, 16, 48, 4, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims", CAUSAL_DIMS,
                         ids=lambda d: "B{}_S{}_H{}_N{}_F{}".format(*d))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.1)],
                         ids=["rate0", "dropout"])
def test_causal_layer_kernels_match_plain(cuda_device, dims, dtype, rates):
    """K1'' causal and its backward against the plain versions, with an
    all-pad row, a row of length 1 and a front-padded row, at sequence
    lengths on and off the 64-key tile; the causal launches are counted
    apart from the bidirectional ones; the backward repeats its bits."""
    b, s, h, n, f = dims
    rng = np.random.default_rng(sum(dims) + 11)
    p = params_from_numpy(flatten(layer_params_np(rng, h, n, f)),
                          cuda_device)
    for leaf in flatten(p).values():
        leaf.requires_grad_(True)
    x = rng.normal(size=(b, s, h)).astype(np.float32)
    mt = torch.from_numpy(causal_mask_np(rng, b, s)).to(cuda_device)
    xt = torch.from_numpy(x).to(cuda_device, dtype).requires_grad_(True)
    dy = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)) \
        .to(cuda_device, dtype)
    kw = dict(num_heads=n, attention_dropout=rates[0],
              output_dropout=rates[1], seed=777, causal=True)
    f_ = fel.fused_encoder_layer
    before = (f_.launches, f_.backward_launches, f_.causal_launches,
              f_.causal_backward_launches)
    y = fel.fused_encoder_layer(p, xt, mt, **kw)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (f_.launches, f_.backward_launches, f_.causal_launches,
            f_.causal_backward_launches) == (before[0], before[1],
                                             before[2] + 1, before[3] + 1)
    with torch.no_grad():
        ref_y = fel.fused_encoder_layer_plain(p, xt, mt, **kw)
        flat = {k: v.detach() for k, v in fel.flat_weights(p).items()}
        ref_dx, ref_g = fel.fused_encoder_layer_plain_backward(
            flat, xt.detach(), mt, dy, **kw)
    tol = 1e-4 if dtype == torch.float32 else 8e-2
    np.testing.assert_allclose(y.detach().float().cpu().numpy(),
                               ref_y.float().cpu().numpy(), rtol=0, atol=tol)
    assert _rel_err(xt.grad, ref_dx) <= GRAD_TOL[dtype]
    got = {k: v.grad for k, v in flatten(p).items()}
    for k, path in zip(fel._W_ORDER, _NAMES):
        g = got[path].reshape(ref_g[k].shape)
        assert _rel_err(g, ref_g[k]) <= GRAD_TOL[dtype], path
    y2, _ = _backward_twice(flat, xt, mt, dy, n, 777, rates, causal=True)
    assert torch.equal(y2, y.detach())


# S = 200 (the temporal path's: a partial last tile) and 130 (two keys past
# a tile boundary), with a head dim of 32 and 8; the temporal train batch
REL_DIMS = [(5, 200, 128, 4, 512), (4, 130, 32, 4, 64),
            (256, 200, 128, 4, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims", REL_DIMS,
                         ids=lambda d: "B{}_S{}_H{}_N{}_F{}".format(*d))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True],
                         ids=["bidirectional", "causal_rel"])
def test_rel_layer_kernels_match_plain(cuda_device, dims, dtype, causal):
    """K1'' rel_bias and K2 dRel against the plain versions (dropout 0.1 /
    0.1, ml-20m_128's), with an all-pad row, a row of length 1 and a
    front-padded row: the output, dx, the weight gradients and dRel; dRel
    is exactly 0 after the diagonal when causal, in every row whose first
    key is real; the relative-bias launches are counted apart; two
    backward runs give the same bits."""
    b, s, h, n, f = dims
    rng = np.random.default_rng(sum(dims) + 23)
    p = params_from_numpy(flatten(layer_params_np(rng, h, n, f)),
                          cuda_device)
    for leaf in flatten(p).values():
        leaf.requires_grad_(True)
    mt = torch.from_numpy(causal_mask_np(rng, b, s)).to(cuda_device)
    xt = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)) \
        .to(cuda_device, dtype).requires_grad_(True)
    rel = torch.from_numpy(rng.normal(size=(b, n, s, s)).astype(np.float32)) \
        .to(cuda_device).requires_grad_(True)
    dy = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)) \
        .to(cuda_device, dtype)
    rates = (0.1, 0.1)
    kw = dict(num_heads=n, attention_dropout=rates[0],
              output_dropout=rates[1], seed=555, causal=causal)
    f_ = fel.fused_encoder_layer
    names = ("launches", "backward_launches", "causal_launches",
             "causal_backward_launches", "rel_launches",
             "rel_backward_launches")
    before = [getattr(f_, k) for k in names]
    y = fel.fused_encoder_layer(p, xt, mt, rel_bias=rel, **kw)
    y.backward(dy)
    torch.cuda.synchronize()
    assert [getattr(f_, k) for k in names] == before[:4] + [
        before[4] + 1, before[5] + 1]
    with torch.no_grad():
        ref_y = fel.fused_encoder_layer_plain(p, xt, mt, rel_bias=rel, **kw)
        flat = {k: v.detach() for k, v in fel.flat_weights(p).items()}
        ref_dx, ref_g = fel.fused_encoder_layer_plain_backward(
            flat, xt.detach(), mt, dy, rel_bias=rel.detach(), **kw)
    tol = 1e-4 if dtype == torch.float32 else 8e-2
    np.testing.assert_allclose(y.detach().float().cpu().numpy(),
                               ref_y.float().cpu().numpy(), rtol=0, atol=tol)
    assert _rel_err(xt.grad, ref_dx) <= GRAD_TOL[dtype]
    assert _rel_err(rel.grad, ref_g["rel"]) <= GRAD_TOL[dtype]
    got = {k: v.grad for k, v in flatten(p).items()}
    for k, path in zip(fel._W_ORDER, _NAMES):
        g = got[path].reshape(ref_g[k].shape)
        assert _rel_err(g, ref_g[k]) <= GRAD_TOL[dtype], path
    if causal:
        # where a row's first key is real every query sees it, so p and dRel
        # after the diagonal are exactly 0; a query that sees only padding
        # (the front-padded row) spreads p over keys after it, as in JAX
        upper = torch.triu(torch.ones(s, s, dtype=torch.bool,
                                      device=cuda_device), 1)
        seen = mt[:, 0] > 0
        assert int((rel.grad[seen][..., upper] != 0).sum()) == 0
    y2, saved = fel._launch_forward(flat, xt.detach(), mt, n, 555, *rates,
                                    True, causal=causal, rel=rel.detach())
    runs = [fel._launch_backward(flat, xt.detach(), mt, dy, saved, n, 555,
                                 *rates, causal=causal, rel=rel.detach())
            for _ in range(2)]
    assert torch.equal(y2, y.detach())
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1]["rel"], runs[1][1]["rel"])
    assert torch.equal(runs[0][1]["rel"], rel.grad)


# --------------------------------------------------------------------------- #
# bf16 K1 / K2 on the warpgroup kernels (csrc/layer_hopper.cuh, attention on
# csrc/flash_hopper.cuh's): each head dim they take, S = 1 and ragged
# against the 64-row tiles, every variant
# --------------------------------------------------------------------------- #

# (B, S, H, N, F): ml-20m_256's width (head dim 32) at S = 200; head dims
# 16, 32 (S = 1), 64 and 128 at S ragged against 64; hidden sizes short of
# the padded 256 and 512 (head dims 48 and 96, the columns split over two
# warpgroups at 384); the train batch (B=256) at ml-20m_256's width and at
# the shapes only the shipped configs reach: beauty_64, ml-1m_64 /
# ml-20m_64, steam_64, beauty_128 / steam_128, beauty_256 / steam_256 and
# ml-1m_256
WGMMA_DIMS = [(2, 200, 256, 8, 1024), (3, 65, 64, 4, 128), (3, 1, 128, 4, 512),
              (3, 130, 128, 2, 256), (2, 63, 256, 2, 512),
              (3, 50, 192, 4, 200), (2, 70, 384, 4, 256),
              (256, 200, 256, 8, 1024), (256, 50, 64, 2, 64),
              (256, 200, 64, 2, 256), (256, 50, 64, 2, 256),
              (256, 50, 128, 4, 512), (256, 50, 256, 8, 1024),
              (256, 200, 256, 8, 512)]
# (attention, output) dropout, causal, relative bias
WGMMA_VARIANTS = {"rate0": ((0.0, 0.0), False, False),
                  "dropout": ((0.2, 0.5), False, False),
                  "causal": ((0.1, 0.1), True, False),
                  "rel": ((0.1, 0.1), False, True),
                  "causal_rel": ((0.0, 0.0), True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("dims", WGMMA_DIMS,
                         ids=lambda d: "B{}_S{}_H{}_N{}_F{}".format(*d))
@pytest.mark.parametrize("variant", list(WGMMA_VARIANTS))
def test_wgmma_layer_kernels_match_plain(cuda_device, dims, variant):
    """The bf16 forward and backward on the wgmma kernels against the plain
    versions (forward 8e-2 absolute, backward 3e-2 of each gradient's
    scale, dRel too), with an all-pad row, a row of length 1 and a
    front-padded row; counted in their variant's counters and never in
    the mma.sync ones; two backward launches give the same bits."""
    b, s, h, n, f = dims
    rates, causal, has_rel = WGMMA_VARIANTS[variant]
    assert fel.kernel_route(torch.bfloat16, b, h, n, f) == "wgmma"
    rng = np.random.default_rng(sum(dims) + 31)
    p = params_from_numpy(flatten(layer_params_np(rng, h, n, f)),
                          cuda_device)
    for leaf in flatten(p).values():
        leaf.requires_grad_(True)
    mt = torch.from_numpy(causal_mask_np(rng, b, s)).to(cuda_device)
    xt = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)) \
        .to(cuda_device, torch.bfloat16).requires_grad_(True)
    dy = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)) \
        .to(cuda_device, torch.bfloat16)
    rel = None
    if has_rel:
        rel = torch.from_numpy(rng.normal(size=(b, n, s, s))
                               .astype(np.float32)).to(cuda_device) \
            .requires_grad_(True)
    kw = dict(num_heads=n, attention_dropout=rates[0],
              output_dropout=rates[1], seed=99, causal=causal)
    f_ = fel.fused_encoder_layer
    kind = "rel_" if has_rel else "causal_" if causal else ""
    names = (f"{kind}launches", f"{kind}backward_launches",
             "mma_sync_launches", "mma_sync_backward_launches")
    before = [getattr(f_, k) for k in names]
    y = fel.fused_encoder_layer(p, xt, mt, rel_bias=rel, **kw)
    y.backward(dy)
    torch.cuda.synchronize()
    assert [getattr(f_, k) for k in names] == [before[0] + 1, before[1] + 1,
                                                before[2], before[3]]
    with torch.no_grad():
        ref_y = fel.fused_encoder_layer_plain(p, xt, mt, rel_bias=rel, **kw)
        flat = {k: v.detach() for k, v in fel.flat_weights(p).items()}
        ref_dx, ref_g = fel.fused_encoder_layer_plain_backward(
            flat, xt.detach(), mt, dy,
            rel_bias=None if rel is None else rel.detach(), **kw)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(y.detach().float().cpu().numpy(),
                               ref_y.float().cpu().numpy(), rtol=0, atol=8e-2)
    assert _rel_err(xt.grad, ref_dx) <= GRAD_TOL[torch.bfloat16]
    got = {k: v.grad for k, v in flatten(p).items()}
    for k, path in zip(fel._W_ORDER, _NAMES):
        g = got[path].reshape(ref_g[k].shape)
        assert _rel_err(g, ref_g[k]) <= GRAD_TOL[torch.bfloat16], path
    if has_rel:
        assert _rel_err(rel.grad, ref_g["rel"]) <= GRAD_TOL[torch.bfloat16]
    _backward_twice(flat, xt, mt, dy, n, 99, rates, causal=causal,
                    rel=None if rel is None else rel.detach())


@pytest.mark.cuda
def test_wgmma_layer_backward_repeats_its_bits_at_h256(cuda_device):
    """Two backward launches at ml-20m_256's width (dropout on, so the
    forward's keep bits are read) give the same bits: the weight
    gradients' cluster and partial sums run in a fixed order."""
    b, s, h, n, f = 2, 200, 256, 8, 1024
    rng = np.random.default_rng(41)
    p = params_from_numpy(flatten(layer_params_np(rng, h, n, f)),
                          cuda_device)
    flat = fel.flat_weights(p)
    x, mask = inputs_np(rng, b, s, h)
    xt = torch.from_numpy(x).to(cuda_device, torch.bfloat16)
    mt = torch.from_numpy(mask).to(cuda_device)
    dy = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)) \
        .to(cuda_device, torch.bfloat16)
    y, saved = fel._launch_forward(flat, xt, mt, n, 5, 0.1, 0.1, True)
    assert saved[-1] is not None and tuple(saved[-1].shape) == \
        fel.keep_bits_shape(b, n, s)
    runs = [fel._launch_backward(flat, xt, mt, dy, saved, n, 5, 0.1, 0.1)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(3, 40, 36, 4, 72), (2, 65, 100, 4, 200)],
                         ids=lambda d: "B{}_S{}_H{}_N{}_F{}".format(*d))
def test_shape_law_routes_to_the_mma_sync_kernels(cuda_device, dims):
    """A bf16 shape the wgmma kernels do not take (a hidden or head dim
    not a multiple of 8) runs the earlier mma.sync kernels, counted apart, and
    still matches the plain versions."""
    b, s, h, n, f = dims
    assert fel.kernel_route(torch.bfloat16, b, h, n, f) == "mma_sync"
    rng = np.random.default_rng(sum(dims))
    p = params_from_numpy(flatten(layer_params_np(rng, h, n, f)),
                          cuda_device)
    for leaf in flatten(p).values():
        leaf.requires_grad_(True)
    x, mask = inputs_np(rng, b, s, h)
    xt = torch.from_numpy(x).to(cuda_device, torch.bfloat16) \
        .requires_grad_(True)
    mt = torch.from_numpy(mask).to(cuda_device)
    dy = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)) \
        .to(cuda_device, torch.bfloat16)
    kw = dict(num_heads=n, attention_dropout=0.2, output_dropout=0.5,
              seed=8)
    f_ = fel.fused_encoder_layer
    names = ("launches", "backward_launches", "mma_sync_launches",
             "mma_sync_backward_launches")
    before = [getattr(f_, k) for k in names]
    y = fel.fused_encoder_layer(p, xt, mt, **kw)
    y.backward(dy)
    torch.cuda.synchronize()
    assert [getattr(f_, k) for k in names] == [v + 1 for v in before]
    with torch.no_grad():
        ref_y = fel.fused_encoder_layer_plain(p, xt, mt, **kw)
        flat = {k: v.detach() for k, v in fel.flat_weights(p).items()}
        ref_dx, ref_g = fel.fused_encoder_layer_plain_backward(
            flat, xt.detach(), mt, dy, **kw)
    np.testing.assert_allclose(y.detach().float().cpu().numpy(),
                               ref_y.float().cpu().numpy(), rtol=0, atol=8e-2)
    assert _rel_err(xt.grad, ref_dx) <= GRAD_TOL[torch.bfloat16]
    got = {k: v.grad for k, v in flatten(p).items()}
    for k, path in zip(fel._W_ORDER, _NAMES):
        assert _rel_err(got[path].reshape(ref_g[k].shape),
                        ref_g[k]) <= GRAD_TOL[torch.bfloat16], path


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.2, 0.5])
@pytest.mark.parametrize("seed,b,site0,n_sites,rows,cols", [
    (777, 8, 0, 6, 200, 200), (2024, 32, 0, 4, 200, 200),
    (2024, 32, 4, 2, 200, 128)], ids=["sites0-5", "attention", "outputs"])
def test_kernel_dropout_masks_equal_plain_masks(cuda_device, rate, seed, b,
                                                site0, n_sites, rows, cols):
    """The CUDA hash's keep masks equal the plain version's, attention's
    sites (S x S) and the outputs' (S x H, from site N), at the keep
    rate."""
    from bert4rec_tpu_torch.ops import dropout_bits
    got = fel.kernel_keep_scale(seed, b, site0, n_sites, rows, cols, rate,
                                cuda_device)
    ref = dropout_bits.keep_scale(seed, b, range(site0, site0 + n_sites),
                                  rows, cols, rate, cuda_device)
    assert torch.equal(got, ref)
    assert abs(float((got > 0).float().mean()) - (1 - rate)) < 3e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(10240, 3709, 128), (300, 104, 32),
                                   (77, 61, 256), (10240, 3709, 64),
                                   (10240, 3709, 256)],
                         ids=lambda d: "R{}_V{}_W{}".format(*d))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fused_loss_kernels_match_plain(cuda_device, shape, dtype):
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    r, vp, w = shape
    v = vp - 3
    rng = np.random.default_rng(r)
    hidden = torch.from_numpy(rng.normal(size=(r, w)).astype(np.float32)) \
        .to(cuda_device, dtype).requires_grad_(True)
    table = torch.from_numpy((rng.normal(size=(vp, w)) * 0.1)
                             .astype(np.float32)).to(cuda_device) \
        .requires_grad_(True)
    bias = torch.from_numpy(rng.normal(size=vp).astype(np.float32)) \
        .to(cuda_device).requires_grad_(True)
    labels_np = rng.integers(0, v, size=r).astype(np.int32)
    labels_np[::7] = 0
    labels = torch.from_numpy(labels_np).to(cuda_device)
    fwd0, bwd0 = fml.fused_mlm_loss.launches, fml.fused_mlm_loss.backward_launches
    loss, cv, ca, nv = fml.fused_mlm_loss(hidden, table, bias, labels, v)
    loss.backward()
    torch.cuda.synchronize()
    assert (fml.fused_mlm_loss.launches,
            fml.fused_mlm_loss.backward_launches) == (fwd0 + 1, bwd0 + 1)
    with torch.no_grad():
        t_s = table.to(dtype)
        b_m = fml._mask_bias(bias, v)
        lse, sums = fml.fused_mlm_loss_plain_forward(hidden, t_s, b_m, labels)
        dh, dt, db = fml.fused_mlm_loss_plain_backward(
            hidden, t_s, b_m, labels, lse, torch.ones(()).to(cuda_device),
            sums[3])
    # the loss sums R fp32 terms in another order; counts are exact unless
    # a logit ties its row max within rounding (random logits: none)
    assert abs(float(loss) - float(sums[0] / sums[3])) <= 1e-5 * float(loss)
    assert [float(cv), float(ca), float(nv)] == sums[1:].tolist()
    for got, ref in ((hidden.grad, dh), (table.grad, dt), (bias.grad, db)):
        assert _rel_err(got, ref) <= (1e-4 if dtype == torch.float32
                                      else 2e-2)
    g = torch.ones((), device=cuda_device)
    runs = [fml._launch_backward(hidden.detach(), t_s, b_m, labels, lse, g,
                                 sums[3:4]) for _ in range(2)]
    assert all(torch.equal(a, c) for a, c in zip(*runs))


# --------------------------------------------------------------------------- #
# the vocab-tiled loss: K5 forward, K6 / K7 backward
# --------------------------------------------------------------------------- #

def _tiled_inputs(device, dtype, r, vp, w, labels="mixed"):
    """``vp - 3`` real columns (3 config-padding columns at -1e9); labels
    ``mixed`` (every 7th row 0), ``padding`` (all 0) or ``sharded`` (the
    valid_ge_zero encoding: -1 none, a sentinel past the table remote)."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    v = vp - 3
    rng = np.random.default_rng(r + w)
    hidden = torch.from_numpy(rng.normal(size=(r, w)).astype(np.float32)) \
        .to(device, dtype)
    table = torch.from_numpy((rng.normal(size=(vp, w)) * 0.1)
                             .astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.normal(size=vp).astype(np.float32)).to(device)
    lab = rng.integers(1, v, size=r).astype(np.int32)
    if labels == "mixed":
        lab[::7] = 0
    elif labels == "padding":
        lab[:] = 0
    else:
        lab[::4] = -1
        lab[1::4] = vp + 7
    return (hidden, table.to(dtype), fml._mask_bias(bias, v),
            torch.from_numpy(lab).to(device), v)


# the ml-20m train shapes with ordinary labels; every label encoding at
# the small shapes (V off every tile, W below and at the kernels' limit);
# then each width the bf16 K6/K7 pad to (64, 128, 256) with R and V on,
# below and past one 64-row tile; K6 at Reddit's vocabulary (R = 2,048
# and 10,240), where each cluster takes many groups of vocabulary tiles;
# the sharded labels at a (1, 2) mesh rank's block of Reddit's table;
# ml-20m_64's width and steam_256's batch
TILED_CASES = [((10240, 26732, w), "mixed") for w in (128, 256)] + [
    (shape, labels) for shape in ((300, 104, 32), (77, 61, 256), (130, 200, 40))
    for labels in ("mixed", "padding", "sharded")] + [
    ((r, vp, w), labels) for w in (64, 128, 256) for r in (1, 63, 64, 65, 130)
    for vp in (61, 65, 200) for labels in ("mixed", "padding", "sharded")] + [
    ((2048, 335424, 128), "mixed"), ((10240, 335424, 128), "mixed"),
    ((2048, 26732, 128), "sharded"), ((10240, 167936, 128), "sharded"),
    ((10240, 26732, 64), "mixed"), ((5120, 13047, 256), "mixed")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,labels", TILED_CASES,
                         ids=lambda c: "R{}_V{}_W{}".format(*c)
                         if isinstance(c, tuple) else c)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_tiled_loss_kernels_match_plain(cuda_device, shape, labels, dtype):
    """K5 (loss and stats entries), K6 and K7 against the plain versions,
    and two runs of each giving the same bits: fp32 K5 on loss_tf32.cuh's
    3xTF32 forward sweep, bf16 K5 on loss_hopper.cuh's. The forward's
    bound: 1e-5 in bf16, whose products are exact in fp32; 1e-4 in fp32,
    as for fp32 K3 (the same sweep), since a 3xTF32 product is a few fp32
    ulps of each term off (a lone row's label logit of 0.25 at W=256 read
    1.5e-5 of its scale)."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    r, vp, w = shape
    h, t, b, lab, _ = _tiled_inputs(cuda_device, dtype, r, vp, w, labels)
    vge0 = labels == "sharded"
    lse, sums = fml._launch_forward_tiled(h, t, b, lab)
    m, s, ll = fml._launch_forward_tiled_stats(h, t, b, lab)
    torch.cuda.synchronize()
    # the plain versions over row chunks whose [rows, V] logits hold at
    # most 2,048 x 335,424 values: per-row outputs joined, the rest summed
    step = max(1, 2048 * 335424 // vp)
    rows = [slice(i, i + step) for i in range(0, r, step)]
    fwd = [fml.fused_mlm_loss_plain_forward(h[c], t, b, lab[c]) for c in rows]
    rlse, rsums = torch.cat([f[0] for f in fwd]), sum(f[1] for f in fwd)
    rm, rs, rll = (torch.cat(x) for x in zip(*(
        fml.fused_mlm_loss_plain_stats(h[c], t, b, lab[c]) for c in rows)))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    fwd_tol = 1e-4 if dtype == torch.float32 else 1e-5
    assert _rel_err(lse, rlse) <= fwd_tol
    assert abs(float(sums[0]) - float(rsums[0])) <= \
        fwd_tol * max(abs(float(rsums[0])), 1.0)
    assert sums[1:].tolist() == rsums[1:].tolist()
    for got, ref in ((m, rm), (s, rs), (ll, rll)):
        assert _rel_err(got, ref) <= fwd_tol
    again = fml._launch_forward_tiled(h, t, b, lab)
    assert torch.equal(again[0], lse) and torch.equal(again[1], sums)
    assert all(torch.equal(a, c) for a, c in zip(
        fml._launch_forward_tiled_stats(h, t, b, lab), (m, s, ll)))
    g = torch.full((), 0.5, device=cuda_device)
    nv = rsums[3:4]
    bwd = [fml.fused_mlm_loss_plain_backward(
        h[c], t, b, lab[c], rlse[c], g, nv[0], valid_ge_zero=vge0)
        for c in rows]
    ref = (torch.cat([x[0] for x in bwd]), sum(x[1] for x in bwd),
           sum(x[2] for x in bwd))
    del bwd
    for merged in (True, False):
        got = fml._launch_backward_tiled(h, t, b, lab, lse, g, nv, merged,
                                         valid_ge_zero=vge0)
        again = fml._launch_backward_tiled(h, t, b, lab, lse, g, nv, merged,
                                           valid_ge_zero=vge0)
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(got, again))
        for a, c in zip(got, ref):
            if not bool(c.abs().any()):
                assert not bool(a.abs().any())
            else:
                assert _rel_err(a, c) <= tol, ("K6" if merged else "K7")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,w,kernel", [(10240, 128, "K6"),
                                           (10240, 256, "K7")])
def test_tiled_autograd_launches_by_the_merged_law(cuda_device, rows, w,
                                                   kernel):
    """``mlm_loss_and_metrics`` at ml-20m's table launches K5 once and
    then K6 (W=128) or K7 (W=256), and its gradients match the plain
    backward."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    vp = 26732
    h, t, b, lab, v = _tiled_inputs(cuda_device, torch.bfloat16, rows, vp, w)
    assert not fml.fused_loss_supported(vp, w)
    h = h.requires_grad_(True)
    t32 = t.float().requires_grad_(True)
    b32 = b.clone().requires_grad_(True)
    f = fml.fused_mlm_loss_tiled
    before = (f.launches, f.merged_launches, f.two_sweep_launches)
    loss, logs = fml.mlm_loss_and_metrics(h.reshape(256, -1, w), t32, b32,
                                          lab.reshape(256, -1), v)
    loss.backward()
    torch.cuda.synchronize()
    after = (f.launches, f.merged_launches, f.two_sweep_launches)
    assert after[0] - before[0] == 1
    assert (after[1] - before[1], after[2] - before[2]) == \
        ((1, 0) if kernel == "K6" else (0, 1))
    with torch.no_grad():
        rlse, rsums = fml.fused_mlm_loss_plain_forward(h, t, b, lab)
        dh, dt, db = fml.fused_mlm_loss_plain_backward(
            h, t, b, lab, rlse, torch.ones((), device=cuda_device), rsums[3])
    db[v:] = 0
    assert abs(float(loss) - float(rsums[0] / rsums[3])) <= 1e-5 * float(loss)
    for got, ref in ((h.grad, dh), (t32.grad, dt), (b32.grad, db)):
        assert _rel_err(got, ref) <= 2e-2


@pytest.mark.cuda
def test_tiled_bf16_rejects_a_misaligned_view(cuda_device):
    """A bf16 hidden whose base is not 16-byte aligned, or whose width is
    not a multiple of 8, raises before K5 (both entries), K6/K7 and the
    whole-table forward K3 (K5's sweep) launch: their copies read 16-byte
    pieces of each row; nothing of K3-K7 is counted."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    h, t, b, lab, v = _tiled_inputs(cuda_device, torch.bfloat16, 130, 200,
                                    64)
    flat = torch.zeros(h.numel() + 1, device=cuda_device,
                       dtype=torch.bfloat16)
    shifted = flat[1:].view(h.shape).copy_(h)           # base 2 bytes off
    h36, t36, b36, lab36, v36 = _tiled_inputs(cuda_device, torch.bfloat16,
                                              130, 200, 36)
    f, w = fml.fused_mlm_loss_tiled, fml.fused_mlm_loss
    for hh, tt, bb, ll, vv in ((shifted, t, b, lab, v),
                               (h36, t36, b36, lab36, v36)):
        before = (f.launches, f.merged_launches, f.two_sweep_launches,
                  w.launches, w.backward_launches)
        hh = hh.detach().requires_grad_(True)
        for entry in (f, fml.fused_mlm_loss_tiled_stats):
            with pytest.raises(ValueError, match="16-byte"):
                entry(hh, tt, bb, ll, vv)
        with pytest.raises(ValueError, match="16-byte"):
            fml._launch_backward_tiled(hh.detach(), tt, bb, ll,
                                       torch.zeros(len(ll), device=cuda_device),
                                       torch.ones((), device=cuda_device),
                                       torch.ones(1, device=cuda_device), True)
        with pytest.raises(ValueError, match="16-byte"):
            w(hh, tt, bb, ll, vv)
        assert (f.launches, f.merged_launches, f.two_sweep_launches,
                w.launches, w.backward_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["width_18", "shifted_base", "column_slice"])
@pytest.mark.parametrize("kernel", ["K5", "K6", "K7"])
def test_tiled_fp32_takes_any_layout_through_a_copy(cuda_device, case,
                                                    kernel):
    """fp32 K5 (both entries), K6 and K7 copy 16-byte pieces of each row (W
    a multiple of 4): a width off that rule, a base 4 bytes off 16 and a
    column slice run through the wrapper's aligned, zero-filled copy and
    match the plain versions within 1e-4 (K5: lse, the loss sum and the
    stats relative to their scale, the counts equal), the gradients at the
    caller's width."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    w = 18 if case == "width_18" else 64
    h, t, b, lab, _ = _tiled_inputs(cuda_device, torch.float32, 130, 200, w)
    if case == "shifted_base":
        def shift(x):
            flat = torch.zeros(x.numel() + 1, device=cuda_device)
            return flat[1:].view(x.shape).copy_(x)
        h, t = shift(h), shift(t)
        assert h.data_ptr() % 16 and t.data_ptr() % 16
    elif case == "column_slice":
        def widen(x):
            wide = torch.zeros((x.shape[0], 72), device=cuda_device)
            wide[:, :64] = x
            return wide[:, :64]
        h, t = widen(h), widen(t)
        assert not h.is_contiguous()
    lse, sums = fml.fused_mlm_loss_plain_forward(h, t, b, lab)
    if kernel == "K5":
        got_lse, got_sums = fml._launch_forward_tiled(h, t, b, lab)
        stats = fml._launch_forward_tiled_stats(h, t, b, lab)
        torch.cuda.synchronize()
        assert _rel_err(got_lse, lse) <= 1e-4
        assert abs(float(got_sums[0]) - float(sums[0])) <= \
            1e-4 * max(abs(float(sums[0])), 1.0)
        assert got_sums[1:].tolist() == sums[1:].tolist()
        for a, c in zip(stats, fml.fused_mlm_loss_plain_stats(h, t, b, lab)):
            assert a.shape == c.shape and _rel_err(a, c) <= 1e-4
        return
    g = torch.full((), 0.5, device=cuda_device)
    ref = fml.fused_mlm_loss_plain_backward(h, t, b, lab, lse, g, sums[3])
    got = fml._launch_backward_tiled(h, t, b, lab, lse, g, sums[3:4],
                                     kernel == "K6")
    torch.cuda.synchronize()
    for a, c in zip(got, ref):
        assert a.shape == c.shape and a.is_contiguous()
        assert _rel_err(a, c) <= 1e-4


@pytest.mark.cuda
def test_tiled_fp32_forward_repeats_its_bits(cuda_device):
    """Two runs of fp32 K5, each entry, at ML-20M's batch and width (R =
    10,240, V = 26,732, W = 128), at Reddit's vocabulary and at W = 256
    give the same bits: every split's stats are merged in split order, no
    atomics."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    for r, vp, w in ((10240, 26732, 128), (2048, 335424, 128),
                     (1000, 26732, 256)):
        h, t, b, lab, _ = _tiled_inputs(cuda_device, torch.float32, r, vp, w)
        for fn in (fml._launch_forward_tiled,
                   fml._launch_forward_tiled_stats):
            one, two = fn(h, t, b, lab), fn(h, t, b, lab)
            torch.cuda.synchronize()
            assert all(torch.equal(a, c) for a, c in zip(one, two)), \
                (r, vp, w, fn.__name__)


def _edge_inputs(device, r, v, w, seed, dtype=torch.bfloat16):
    """hidden [r, w], table [v, w] (bf16 unless ``dtype``), an unmasked
    fp32 bias [v] and labels that reach every edge of the column range:
    column 0 (a padding row), column v - 1 (in the ragged last tile when v
    is off the tile), v and past it (match no column), -1 and -2 (the
    sharded forward's encodings), then random columns with every 7th row
    0."""
    rng = np.random.default_rng(seed)
    hidden = torch.from_numpy(rng.normal(size=(r, w)).astype(np.float32)) \
        .to(device, dtype)
    table = torch.from_numpy((rng.normal(size=(v, w)) * 0.1)
                             .astype(np.float32)).to(device, dtype)
    bias = torch.from_numpy(rng.normal(size=v).astype(np.float32)).to(device)
    lab = rng.integers(1, v, size=r).astype(np.int32)
    lab[::7] = 0
    edges = [0, v - 1, v, v + 40, -1, -2][:r]
    lab[:len(edges)] = edges
    return hidden, table, bias, torch.from_numpy(lab).to(device)


# widths the bf16 kernels pad to; R and V on, below and past their tiles
# (64 vocabulary rows, 64 and 128 hidden rows)
EDGE_SHAPES = [(r, v, w) for w in (64, 128, 256)
               for r, v in ((1, 61), (127, 64), (129, 200), (300, 1030))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=lambda d: "R{}_V{}_W{}".format(*d))
def test_bf16_loss_kernels_at_the_label_edges(cuda_device, shape):
    """bf16 K5 (loss and stats entries) and bf16 K4 (from K3's lse)
    against their plain versions with labels at column 0, column V - 1,
    V and past it, -1 and -2: the loss forward within 1e-5 of its scale,
    counts equal, the stats within 1e-5; the backward within 2e-2 of each
    gradient's scale; two runs of each giving the same bits."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    r, v, w = shape
    h, t, b, lab = _edge_inputs(cuda_device, r, v, w, r * v + w)
    lse, sums = fml._launch_forward_tiled(h, t, b, lab)
    stats = fml._launch_forward_tiled_stats(h, t, b, lab)
    rlse, rsums = fml.fused_mlm_loss_plain_forward(h, t, b, lab)
    rstats = fml.fused_mlm_loss_plain_stats(h, t, b, lab)
    assert _rel_err(lse, rlse) <= 1e-5
    assert abs(float(sums[0]) - float(rsums[0])) <= \
        1e-5 * max(abs(float(rsums[0])), 1.0)
    assert sums[1:].tolist() == rsums[1:].tolist()
    for got, ref in zip(stats, rstats):
        assert _rel_err(got, ref) <= 1e-5
    again = fml._launch_forward_tiled(h, t, b, lab)
    assert torch.equal(again[0], lse) and torch.equal(again[1], sums)
    assert all(torch.equal(a, c) for a, c in
               zip(fml._launch_forward_tiled_stats(h, t, b, lab), stats))
    # K4 from K3's lse, the whole-table path's pair
    k3_lse, k3_sums = fml._launch_forward(h, t, b, lab)
    g = torch.full((), 0.75, device=cuda_device)
    got = fml._launch_backward(h, t, b, lab, k3_lse, g, k3_sums[3:4])
    again = fml._launch_backward(h, t, b, lab, k3_lse, g, k3_sums[3:4])
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    ref = fml.fused_mlm_loss_plain_backward(h, t, b, lab, rlse, g, rsums[3])
    for a, c in zip(got, ref):
        if not bool(c.abs().any()):
            assert not bool(a.abs().any())
        else:
            assert _rel_err(a, c) <= 2e-2


@pytest.mark.parametrize("shape", EDGE_SHAPES,
                         ids=lambda d: "R{}_V{}_W{}".format(*d))
@pytest.mark.cuda
def test_bf16_whole_table_forward_at_the_label_edges(cuda_device, shape):
    """bf16 K3 (K5's sweep over the whole table, then the ordered merge)
    against its plain version with labels at column 0, V - 1, V and past
    it, -1 and -2: lse and the loss sum within 1e-4 relative, the counts
    equal, two runs the same bits."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    r, v, w = shape
    h, t, b, lab = _edge_inputs(cuda_device, r, v, w, r + v + w)
    rlse, rsums = fml.fused_mlm_loss_plain_forward(h, t, b, lab)
    lse, sums = fml._launch_forward(h, t, b, lab)
    again = fml._launch_forward(h, t, b, lab)
    torch.cuda.synchronize()
    assert _rel_err(lse, rlse) <= 1e-4
    assert abs(float(sums[0]) - float(rsums[0])) <= \
        1e-4 * max(abs(float(rsums[0])), 1.0)
    assert sums[1:].tolist() == rsums[1:].tolist()
    assert torch.equal(again[0], lse) and torch.equal(again[1], sums)


@pytest.mark.parametrize("shape", [
    (10240, 3709, 128), (10240, 3709, 256), (10240, 3709, 64),
    (300, 104, 32), (300, 104, 200), (77, 61, 256), (1, 61, 128),
    (2048, 26732, 128), (130, 200, 64), (129, 4000, 256)],
    ids=lambda d: "R{}_V{}_W{}".format(*d))
@pytest.mark.cuda
def test_bf16_whole_table_split_law_mirrors_the_library(cuda_device, shape):
    """The library splits bf16 K3's vocabulary by its own law and sizes
    its workspace by it (splits x R row stats): the Python mirror
    ``whole_table_workspace_bytes`` (from ``whole_table_splits``) gives the
    library's bytes at 64- and 128-entry vocabulary tiles, where the split
    count is capped by the tiles and where it is not."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    r, v, w = shape
    assert fml.workspace_bytes("K3/K4", r, v, w) == \
        fml.whole_table_workspace_bytes(r, v, w)


@pytest.mark.cuda
def test_bf16_whole_table_workspace_does_not_grow_with_the_vocabulary(
        cuda_device):
    """K3/K4's workspace is K3's split row stats and row-block sums (K4's
    sweeps sum their partials through distributed shared memory), in both
    dtypes: the library's bytes are ``whole_table_workspace_bytes``'s, the
    same at V = 3,709 and V = 335,424 (fp32 K3's 4 splits at this batch
    whatever the vocabulary; fp32 K4's split dtable partials are gone)."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    r, w = 10240, 128
    bf16 = [fml.workspace_bytes("K3/K4", r, v, w) for v in (3709, 335424)]
    fp32 = [fml.workspace_bytes("K3/K4", r, v, w, torch.float32)
            for v in (3709, 335424)]
    assert bf16[0] == bf16[1] == fml.whole_table_workspace_bytes(r, 3709, w)
    assert fp32[0] == fp32[1] == fml.whole_table_workspace_bytes(
        r, 3709, w, torch.float32)
    assert fp32[0] < (r // 1024) * 3709 * w * 4 / 10


@pytest.mark.parametrize("shape", [
    (10240, 3709, 128), (10240, 3709, 256), (10240, 3709, 64),
    (300, 104, 32), (300, 104, 200), (77, 61, 256), (1, 61, 128),
    (2048, 26732, 128), (130, 200, 64), (129, 4000, 256), (6144, 3709, 64)],
    ids=lambda d: "R{}_V{}_W{}".format(*d))
@pytest.mark.cuda
def test_fp32_whole_table_split_law_mirrors_the_library(cuda_device, shape):
    """fp32 K3 splits the vocabulary by fp32 K5's law (128-row blocks x
    splits up to 1,024, at most one split per 64-entry tile; at W > 128
    64-row tiles x splits up to 512, 32-entry tiles) and sizes its
    workspace by it: the Python mirror gives the library's bytes, where
    the split count is capped by the tiles and where not."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    r, v, w = shape
    assert fml.workspace_bytes("K3/K4", r, v, w, torch.float32) == \
        fml.whole_table_workspace_bytes(r, v, w, torch.float32)


@pytest.mark.parametrize("shape", [
    (10240, 26732, 128), (10240, 26732, 256), (10240, 26732, 64),
    (2048, 335424, 128), (10240, 335424, 128), (300, 104, 32),
    (77, 61, 256), (1, 61, 128), (130, 200, 40), (6144, 3709, 64)],
    ids=lambda d: "R{}_V{}_W{}".format(*d))
@pytest.mark.cuda
def test_fp32_tiled_forward_split_law_mirrors_the_library(cuda_device,
                                                          shape):
    """fp32 K5 splits the vocabulary by its law (bf16 K5's at W <= 128:
    128-row blocks x splits up to 1,024, at most one split per 64-entry
    tile; at W > 128 64-row tiles x splits up to 512, 32-entry tiles) and
    sizes its workspace by it: the Python mirror
    ``tiled_forward_workspace_bytes`` (from ``tiled_forward_splits(...,
    torch.float32)``) gives the library's bytes at ML-20M's and Reddit's
    shapes, where the split count is capped by the tiles and where not."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    r, v, w = shape
    assert fml.workspace_bytes("K5", r, v, w, torch.float32) == \
        fml.tiled_forward_workspace_bytes(r, v, w, torch.float32)
    assert fml.workspace_bytes("K5", r, v, w) == \
        fml.tiled_forward_workspace_bytes(r, v, w)


@pytest.mark.cuda
def test_fp32_whole_table_sweep_grid_at_ml1m(cuda_device):
    """fp32 K4 at ml-1m's batch runs fp32 K7's sweeps: the dh sweep's 160
    row tiles in clusters of 8 (1,280 blocks) and the dt sweep's 58
    vocabulary tiles in clusters of 8 (464 blocks, one an SM)."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    assert fml.sweep_grid(10240, 3709, 128, torch.float32) == \
        {"dh": (1280, 8), "dt": (464, 8)}


# fp32 K3 / K4 (3xTF32): ml-1m's batch at each width the kernels pad to,
# then R and V on, below and past their tiles (64 rows; 64 vocabulary
# entries, 32 at W > 128) with widths off every pad
FP32_WHOLE_TABLE = [(10240, 3709, w) for w in (128, 64, 256)] + [
    (r, v, w) for w in (40, 64, 128, 256)
    for r, v in ((1, 61), (63, 64), (65, 200), (300, 1030))]


@pytest.mark.parametrize("shape", FP32_WHOLE_TABLE,
                         ids=lambda d: "R{}_V{}_W{}".format(*d))
@pytest.mark.cuda
def test_fp32_whole_table_kernels_match_plain(cuda_device, shape):
    """fp32 K3 (loss_tf32.cuh's forward sweep and the ordered merge) and
    fp32 K4 (fp32 K7's two sweeps from K3's lse) against their plain
    versions with labels at column 0, V - 1, V and past it, -1 and -2: lse
    and the loss sum within 1e-4 relative, the counts equal; each gradient
    within 1e-4 of its scale; two runs of each the same bits."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    r, v, w = shape
    h, t, b, lab = _edge_inputs(cuda_device, r, v, w, r + v + w,
                                torch.float32)
    rlse, rsums = fml.fused_mlm_loss_plain_forward(h, t, b, lab)
    lse, sums = fml._launch_forward(h, t, b, lab)
    again = fml._launch_forward(h, t, b, lab)
    torch.cuda.synchronize()
    assert _rel_err(lse, rlse) <= 1e-4
    assert abs(float(sums[0]) - float(rsums[0])) <= \
        1e-4 * max(abs(float(rsums[0])), 1.0)
    assert sums[1:].tolist() == rsums[1:].tolist()
    assert torch.equal(again[0], lse) and torch.equal(again[1], sums)
    g = torch.full((), 0.75, device=cuda_device)
    got = fml._launch_backward(h, t, b, lab, lse, g, sums[3:4])
    again = fml._launch_backward(h, t, b, lab, lse, g, sums[3:4])
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    ref = fml.fused_mlm_loss_plain_backward(h, t, b, lab, rlse, g, rsums[3])
    for a, c in zip(got, ref):
        assert a.shape == c.shape and a.dtype == torch.float32
        if not bool(c.abs().any()):
            assert not bool(a.abs().any())
        else:
            assert _rel_err(a, c) <= 1e-4


@pytest.mark.parametrize("shape", FP32_WHOLE_TABLE,
                         ids=lambda d: "R{}_V{}_W{}".format(*d))
@pytest.mark.cuda
def test_fp32_tiled_forward_at_the_label_edges(cuda_device, shape):
    """fp32 K5, both entries (loss_tf32.cuh's forward sweep over the
    vocabulary splits, then the ordered merge), against the plain versions
    with labels at column 0, V - 1, V and past it, -1 and -2 (a label
    outside [0, V) matches no column): lse, the loss sum and the stats
    within 1e-4 of their scale, the counts equal, two runs the same bits."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    r, v, w = shape
    h, t, b, lab = _edge_inputs(cuda_device, r, v, w, r * v + w,
                                torch.float32)
    rlse, rsums = fml.fused_mlm_loss_plain_forward(h, t, b, lab)
    rstats = fml.fused_mlm_loss_plain_stats(h, t, b, lab)
    lse, sums = fml._launch_forward_tiled(h, t, b, lab)
    stats = fml._launch_forward_tiled_stats(h, t, b, lab)
    again = fml._launch_forward_tiled(h, t, b, lab)
    stats_again = fml._launch_forward_tiled_stats(h, t, b, lab)
    torch.cuda.synchronize()
    assert _rel_err(lse, rlse) <= 1e-4
    assert abs(float(sums[0]) - float(rsums[0])) <= \
        1e-4 * max(abs(float(rsums[0])), 1.0)
    assert sums[1:].tolist() == rsums[1:].tolist()
    for got, ref in zip(stats, rstats):
        assert got.shape == ref.shape and _rel_err(got, ref) <= 1e-4
    assert torch.equal(again[0], lse) and torch.equal(again[1], sums)
    assert all(torch.equal(a, c) for a, c in zip(stats_again, stats))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["width_18", "shifted_base", "column_slice"])
def test_fp32_whole_table_takes_any_layout_through_a_copy(cuda_device, case):
    """fp32 K3 / K4 copy 16-byte pieces of each row (W a multiple of 4): a
    width off that rule, a base 4 bytes off 16 and a column slice run
    through the wrapper's aligned, zero-filled copy and match the plain
    versions within 1e-4, the gradients at the caller's width."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    w = 18 if case == "width_18" else 64
    h, t, b, lab, _ = _tiled_inputs(cuda_device, torch.float32, 130, 200, w)
    if case == "shifted_base":
        def shift(x):
            flat = torch.zeros(x.numel() + 1, device=cuda_device)
            return flat[1:].view(x.shape).copy_(x)
        h, t = shift(h), shift(t)
        assert h.data_ptr() % 16 and t.data_ptr() % 16
    elif case == "column_slice":
        def widen(x):
            wide = torch.zeros((x.shape[0], 72), device=cuda_device)
            wide[:, :64] = x
            return wide[:, :64]
        h, t = widen(h), widen(t)
        assert not h.is_contiguous()
    rlse, rsums = fml.fused_mlm_loss_plain_forward(h, t, b, lab)
    lse, sums = fml._launch_forward(h, t, b, lab)
    g = torch.full((), 0.5, device=cuda_device)
    ref = fml.fused_mlm_loss_plain_backward(h, t, b, lab, rlse, g, rsums[3])
    got = fml._launch_backward(h, t, b, lab, lse, g, sums[3:4])
    torch.cuda.synchronize()
    assert _rel_err(lse, rlse) <= 1e-4
    assert sums[1:].tolist() == rsums[1:].tolist()
    for a, c in zip(got, ref):
        assert a.shape == c.shape and a.is_contiguous()
        assert _rel_err(a, c) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("r,v,splits", [(10240, 26732, 13), (2048, 335424, 64),
                                        (130, 200, 4), (1, 61, 1)])
def test_bf16_tiled_forward_splits_the_vocabulary_by_its_law(cuda_device, r,
                                                             v, splits):
    """bf16 K5 splits the vocabulary until (128-row blocks x splits)
    reaches 1,024, at most one split per 64-entry vocabulary tile; its
    workspace is the splits' (max, sum, label logit) rows and the row-block
    sums, each rounded up to 256 bytes."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    up = lambda n: -(-n // 256) * 256  # noqa: E731
    want = 3 * up(splits * r * 4) + up(-(-r // 256) * 16)
    assert fml.workspace_bytes("K5", r, v, 128) == want


@pytest.mark.cuda
def test_tiled_workspace_does_not_grow_with_the_vocabulary(cuda_device):
    """At Reddit's vocabulary and the train batch's rows no workspace of
    K5-K7 holds a (rows / chunk) x V x W term, as K4's split dtable
    partials do: K5 asks for splits x R x 3 floats, K6 for at most 128 dh
    partials of R x W floats (one per cluster, at most 32, in both
    dtypes), K7 for none, and each is the same at V = 26,732 and
    V = 335,424."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    r, w = 10240, 128
    split_partials = (r // 1024) * 335424 * w * 4
    sizes = {k: [fml.workspace_bytes(k, r, v, w) for v in (26732, 335424)]
             for k in ("K5", "K6", "K7")}
    fp32 = {k: [fml.workspace_bytes(k, r, v, w, torch.float32)
                for v in (26732, 335424)] for k in ("K6", "K7")}
    for k, (small, large) in list(sizes.items()) + list(fp32.items()):
        assert small == large, k
    assert fp32["K7"][1] == 0
    assert fp32["K6"][1] <= 128 * r * w * 4 + 256
    assert sizes["K7"][1] == 0
    assert sizes["K6"][1] <= 128 * r * w * 4 + 256
    assert sizes["K5"][1] <= 4 * (r * 3 * 16 + r)
    assert max(s[1] for s in sizes.values()) < split_partials / 2


@pytest.mark.cuda
def test_device_put_copies_through_pinned_memory_on_a_side_stream(
        cuda_device):
    """The prefetch thread's placement: every key lands on the card equal
    to its array, the copy has finished when ``put`` returns, and prefetch
    keeps the order of the batches."""
    from bert4rec_tpu_torch.utils import prefetch
    put = prefetch.device_put(cuda_device, ("a", "b"))
    rng = np.random.default_rng(0)
    host = [{"a": rng.integers(0, 9, size=(256, 200)).astype(np.int32),
             "b": rng.integers(0, 9, size=(256, 40)).astype(np.int32),
             "c": np.zeros(3)} for _ in range(6)]
    for want, got in zip(host, prefetch.prefetch(iter(host), put, depth=2)):
        assert set(got) == {"a", "b"}
        for k in got:
            assert got[k].device.type == "cuda"
            np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])


# --------------------------------------------------------------------------- #
# flash attention: K8 forward, K9 backward
# --------------------------------------------------------------------------- #

def flash_operands(device, dims, dtype, seed):
    """q, k, v as strided views of one ``[B, S, 3, N, D]`` projection (the
    layout the unfused block hands the kernels), a mask with a full row, a
    row of length 1, an all-pad row and (B > 3) a front-padded one, and
    dO."""
    b, n, s, d = dims
    rng = np.random.default_rng(seed)
    proj = torch.from_numpy(rng.normal(size=(b, s, 3, n, d))
                            .astype(np.float32)).to(device, dtype)
    q, k, v = (proj[:, :, i].transpose(1, 2) for i in range(3))
    mask = torch.from_numpy(causal_mask_np(rng, b, s)).to(device)
    do = torch.from_numpy(rng.normal(size=(b, n, s, d)).astype(np.float32)) \
        .to(device, dtype)
    return q, k, v, mask, do


# the main path's shape (B=32, N=12, S=512, D=64), a ragged one and one
# past JAX's MAX_FUSED_SEQ_LEN
FLASH_DIMS = [(32, 12, 512, 64), (3, 4, 130, 64), (3, 2, 1100, 64)]
# forward, absolute: attention context over a full row of unit-variance
# scores is ~0.07 an entry (rms 0.2-0.7 over these batches' ragged rows), so
# the bf16 limit is set well under it, not at the layers' 8e-2
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dims", FLASH_DIMS,
                         ids=lambda d: "B{}_N{}_S{}_D{}".format(*d))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["rate0", "dropout"])
@pytest.mark.parametrize("causal", [False, True],
                         ids=["bidirectional", "causal"])
def test_flash_kernels_match_plain(cuda_device, dims, dtype, rate, causal):
    """K8 and K9 against their plain versions on strided q, k, v: forward
    within 1e-4 (fp32) or 2e-2 (bf16) absolute, gradients within GRAD_TOL
    of their scale."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    q, k, v, mask, do = flash_operands(cuda_device, dims, dtype, sum(dims))
    o, saved = fa._launch_forward(q, k, v, mask, 99, rate, causal, True)
    grads = fa._launch_backward(q, k, v, mask, do, saved, 99, rate, causal)
    torch.cuda.synchronize()
    ref = fa.mha_reference(q, k, v, mask, rate, 99, causal)
    ref_grads = fa.flash_attention_plain_backward(
        q, k, v, mask, do, dropout_rate=rate, seed=99, causal=causal)
    assert o.shape == q.shape and o.dtype == dtype
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=0,
                               atol=FLASH_TOL[dtype])
    for name, got, want in zip("qkv", grads, ref_grads):
        assert bool(torch.isfinite(got).all()), name
        assert _rel_err(got, want) <= GRAD_TOL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("dims", FLASH_DIMS,
                         ids=lambda d: "B{}_N{}_S{}_D{}".format(*d))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_strided_equals_contiguous_and_backward_repeats(cuda_device,
                                                              dims, dtype):
    """The projection's views and their contiguous copies give the same
    bits; two K9 runs give the same bits, dropout 0 and 0.2, causal or
    not; autograd counts one launch of each (causal apart)."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    q, k, v, mask, do = flash_operands(cuda_device, dims, dtype, 5)
    cq, ck, cv = (t.contiguous() for t in (q, k, v))
    assert not q.is_contiguous() and cq.is_contiguous()
    for causal, rate in ((False, 0.0), (True, 0.0), (False, 0.2),
                         (True, 0.2)):
        o1, s1 = fa._launch_forward(q, k, v, mask, 3, rate, causal, True)
        o2, s2 = fa._launch_forward(cq, ck, cv, mask, 3, rate, causal, True)
        g1 = fa._launch_backward(q, k, v, mask, do, s1, 3, rate, causal)
        g2 = fa._launch_backward(cq, ck, cv, mask, do.transpose(1, 2)
                                 .contiguous().transpose(1, 2), s2, 3, rate,
                                 causal)
        g3 = fa._launch_backward(q, k, v, mask, do, s1, 3, rate, causal)
        torch.cuda.synchronize()
        assert torch.equal(o1, o2)
        for a, b, c in zip(g1, g2, g3):
            assert torch.equal(a, b) and torch.equal(a, c)
    f = fa.flash_attention
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    before = (f.launches, f.backward_launches, f.causal_launches,
              f.causal_backward_launches)
    out = fa.flash_attention(qs, ks, vs, mask, 0.2, seed=3, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert (f.launches, f.backward_launches, f.causal_launches,
            f.causal_backward_launches) == (before[0], before[1],
                                            before[2] + 1, before[3] + 1)
    assert torch.equal(out.detach(), o1)
    assert torch.equal(qs.grad, g1[0])


@pytest.mark.cuda
def test_flash_rejects_a_stride_it_does_not_take(cuda_device):
    """A head-dim axis that is not contiguous raises before any launch."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    q, k, v, mask, _ = flash_operands(cuda_device, (2, 2, 64, 32),
                                      torch.float32, 6)
    wide = torch.zeros((2, 2, 64, 64), device=cuda_device)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="contiguous last axis"):
        fa.flash_attention(wide[..., ::2], k, v, mask)
    with pytest.raises(ValueError):
        fa.head_strides(wide[..., ::2])
    assert fa.flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_kernels_run_past_the_jax_sequence_limit(cuda_device, dtype):
    """Past JAX's MAX_FUSED_SEQ_LEN a CUDA tensor still launches K8/K9 (the
    plain route is the CPU's only), and they match the plain versions;
    past MAX_KERNEL_SEQ_LEN the call raises before any launch."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    dims = (2, 2, fa.MAX_FUSED_SEQ_LEN + 76, 64)
    q, k, v, mask, do = flash_operands(cuda_device, dims, dtype, 7)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    f = fa.flash_attention
    before = (f.launches, f.backward_launches)
    out = f(qs, ks, vs, mask, 0.2, seed=5)
    out.backward(do)
    torch.cuda.synchronize()
    assert (f.launches, f.backward_launches) == (before[0] + 1,
                                                 before[1] + 1)
    ref = fa.mha_reference(q, k, v, mask, 0.2, 5)
    np.testing.assert_allclose(out.detach().float().cpu().numpy(),
                               ref.float().cpu().numpy(), rtol=0,
                               atol=FLASH_TOL[dtype])
    ref_grads = fa.flash_attention_plain_backward(
        q, k, v, mask, do, dropout_rate=0.2, seed=5)
    for name, got, want in zip("qkv", (qs.grad, ks.grad, vs.grad),
                               ref_grads):
        assert _rel_err(got, want) <= GRAD_TOL[dtype], name
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "MAX_KERNEL_SEQ_LEN", dims[2] - 1)
        with pytest.raises(ValueError, match="S <="):
            f(q, k, v, mask)
    assert f.launches == before[0] + 1


# fp32 with a head dim that is a multiple of 8 up to 64 runs the 3xTF32
# kernels of csrc/flash_tf32.cuh (flash_route "tf32"): the main path's shape,
# ragged lengths, S = 1, one past JAX's 1,024, and the head dims 8-64
FLASH_TF32_DIMS = [(32, 12, 512, 64), (3, 4, 130, 64), (2, 2, 1100, 64),
                   (4, 2, 1, 64), (4, 3, 130, 32), (4, 2, 65, 8),
                   (3, 2, 200, 40)]


def _flash_counts(fa):
    f = fa.flash_attention
    return {name: getattr(f, name) for name in (
        "tf32_launches", "tf32_backward_launches", "simt_launches",
        "simt_backward_launches")}


@pytest.mark.cuda
@pytest.mark.parametrize("dims", FLASH_TF32_DIMS,
                         ids=lambda d: "B{}_N{}_S{}_D{}".format(*d))
def test_flash_fp32_tf32_kernels_match_plain(cuda_device, dims):
    """fp32 K8/K9 on the 3xTF32 route against their plain versions,
    bidirectional and causal, dropout 0 and 0.2, on strided views with an
    all-pad row, a length-1 row and a front-padded row: forward within 1e-4
    absolute, gradients within 1e-4 of their scale; K8's inference entry
    (nothing saved) gives the training entry's bits at rate 0."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    assert fa.flash_route(torch.float32, dims[3]) == "tf32"
    q, k, v, mask, do = flash_operands(cuda_device, dims, torch.float32,
                                       sum(dims) + 1)
    for causal, rate in ((False, 0.0), (False, 0.2), (True, 0.0),
                         (True, 0.2)):
        o, saved = fa._launch_forward(q, k, v, mask, 43, rate, causal, True)
        grads = fa._launch_backward(q, k, v, mask, do, saved, 43, rate,
                                    causal)
        torch.cuda.synchronize()
        ref = fa.mha_reference(q, k, v, mask, rate, 43, causal)
        ref_grads = fa.flash_attention_plain_backward(
            q, k, v, mask, do, dropout_rate=rate, seed=43, causal=causal)
        label = f"causal={causal} rate={rate}"
        assert len(saved) == 3 and saved[2] is o, label
        assert float((o - ref).abs().max()) <= FLASH_TOL[torch.float32], label
        for name, got, want in zip("qkv", grads, ref_grads):
            assert bool(torch.isfinite(got).all()), (name, label)
            assert _rel_err(got, want) <= GRAD_TOL[torch.float32], \
                (name, label)
        if rate == 0.0:
            served, none = fa._launch_forward(q, k, v, mask, 43, 0.0, causal,
                                              False)
            torch.cuda.synchronize()
            assert none == () and torch.equal(served, o), label


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 32, 40, 64], ids=lambda d: f"D{d}")
def test_flash_fp32_tf32_strided_equals_contiguous_and_backward_repeats(
        cuda_device, d):
    """On the 3xTF32 route the projection's views and their contiguous
    copies give the same bits, and two K9 runs the same bits."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    q, k, v, mask, do = flash_operands(cuda_device, (4, 3, 130, d),
                                       torch.float32, d + 1)
    copies = [t.contiguous() for t in (q, k, v)]
    for causal in (False, True):
        o1, s1 = fa._launch_forward(q, k, v, mask, 8, 0.2, causal, True)
        o2, s2 = fa._launch_forward(*copies, mask, 8, 0.2, causal, True)
        g1 = fa._launch_backward(q, k, v, mask, do, s1, 8, 0.2, causal)
        g2 = fa._launch_backward(*copies, mask, do, s2, 8, 0.2, causal)
        g3 = fa._launch_backward(q, k, v, mask, do, s1, 8, 0.2, causal)
        torch.cuda.synchronize()
        assert torch.equal(o1, o2)
        for a, b, c in zip(g1, g2, g3):
            assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_flash_fp32_takes_a_misaligned_view_through_a_copy(cuda_device):
    """An fp32 view whose base is 4 bytes off the 16-byte rule is copied
    and launches the 3xTF32 kernels (counted in ``tf32_launches``, none in
    ``simt_launches``) with the aligned copy's bits."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    q, k, v, mask, do = flash_operands(cuda_device, (3, 2, 130, 64),
                                       torch.float32, 11)
    shifted = torch.zeros(v.numel() + 1, device=cuda_device)[1:] \
        .view(v.shape).copy_(v)
    assert fa._misaligned(shifted)
    before = _flash_counts(fa)
    ts = [t.detach().requires_grad_(True) for t in (q, k, shifted)]
    out = fa.flash_attention(*ts, mask, 0.2, seed=4)
    out.backward(do)
    torch.cuda.synchronize()
    after = _flash_counts(fa)
    assert after == dict(before, tf32_launches=before["tf32_launches"] + 1,
                         tf32_backward_launches=before[
                             "tf32_backward_launches"] + 1)
    o, saved = fa._launch_forward(q, k, v.contiguous(), mask, 4, 0.2, False,
                                  True)
    grads = fa._launch_backward(q, k, v.contiguous(), mask, do, saved, 4,
                                0.2, False)
    torch.cuda.synchronize()
    assert torch.equal(out.detach(), o)
    for t, g in zip(ts, grads):
        assert torch.equal(t.grad, g)


@pytest.mark.cuda
@pytest.mark.parametrize("d, route", [(64, "tf32"), (32, "tf32"),
                                      (12, "simt")])
def test_flash_fp32_counts_its_route(cuda_device, d, route):
    """An fp32 forward and backward through autograd count one launch each
    in their route's counters and none in the other's."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    q, k, v, mask, do = flash_operands(cuda_device, (2, 2, 70, d),
                                       torch.float32, d)
    before = _flash_counts(fa)
    ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*ts, mask, 0.2, seed=6)
    out.backward(do)
    torch.cuda.synchronize()
    want = dict(before)
    want[f"{route}_launches"] += 1
    want[f"{route}_backward_launches"] += 1
    assert _flash_counts(fa) == want
    ref = fa.mha_reference(q, k, v, mask, 0.2, 6)
    assert float((out.detach() - ref).abs().max()) <= FLASH_TOL[torch.float32]


# bf16 runs the wgmma kernels of csrc/flash_hopper.cuh: every head dim they
# pad (32, 40 -> 64; 128) and sequence lengths around the 64-row tiles
FLASH_BF16_DIMS = [32, 40, 64, 128]
FLASH_BF16_SEQS = [1, 63, 64, 65, 130, 512, 1100]


@pytest.mark.cuda
@pytest.mark.parametrize("d", FLASH_BF16_DIMS, ids=lambda d: f"D{d}")
@pytest.mark.parametrize("s", FLASH_BF16_SEQS, ids=lambda s: f"S{s}")
def test_flash_bf16_kernels_match_plain_at_each_head_dim_and_length(
        cuda_device, d, s):
    """The bf16 K8/K9 against the plain versions, bidirectional and causal,
    dropout 0 and 0.2, on strided views with an all-pad row, a length-1 row
    and a front-padded row: forward within 2e-2 absolute, gradients within
    3e-2 of their scale."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    q, k, v, mask, do = flash_operands(cuda_device, (4, 2, s, d),
                                       torch.bfloat16, s + d)
    for causal, rate in ((False, 0.0), (False, 0.2), (True, 0.0),
                         (True, 0.2)):
        o, saved = fa._launch_forward(q, k, v, mask, 41, rate, causal, True)
        grads = fa._launch_backward(q, k, v, mask, do, saved, 41, rate,
                                    causal)
        torch.cuda.synchronize()
        ref = fa.mha_reference(q, k, v, mask, rate, 41, causal)
        ref_grads = fa.flash_attention_plain_backward(
            q, k, v, mask, do, dropout_rate=rate, seed=41, causal=causal)
        label = f"causal={causal} rate={rate}"
        assert float((o.float() - ref.float()).abs().max()) \
            <= FLASH_TOL[torch.bfloat16], label
        for name, got, want in zip("qkv", grads, ref_grads):
            assert bool(torch.isfinite(got).all()), (name, label)
            assert _rel_err(got, want) <= GRAD_TOL[torch.bfloat16], \
                (name, label)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 40, 128], ids=lambda d: f"D{d}")
def test_flash_bf16_strided_equals_contiguous_and_backward_repeats(
        cuda_device, d):
    """At the padded head dims too, the projection's views and their
    contiguous copies give the same bits, and two K9 runs the same bits."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    q, k, v, mask, do = flash_operands(cuda_device, (4, 3, 130, d),
                                       torch.bfloat16, d)
    copies = [t.contiguous() for t in (q, k, v)]
    for causal in (False, True):
        o1, s1 = fa._launch_forward(q, k, v, mask, 8, 0.2, causal, True)
        o2, s2 = fa._launch_forward(*copies, mask, 8, 0.2, causal, True)
        g1 = fa._launch_backward(q, k, v, mask, do, s1, 8, 0.2, causal)
        g2 = fa._launch_backward(*copies, mask, do, s2, 8, 0.2, causal)
        g3 = fa._launch_backward(q, k, v, mask, do, s1, 8, 0.2, causal)
        torch.cuda.synchronize()
        assert torch.equal(o1, o2)
        for a, b, c in zip(g1, g2, g3):
            assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_flash_bf16_rejects_a_misaligned_view(cuda_device):
    """A bf16 view whose base or sequence stride is not a multiple of 16
    bytes raises before any launch (the copies read 16-byte pieces)."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    q, k, v, mask, _ = flash_operands(cuda_device, (2, 2, 64, 64),
                                      torch.bfloat16, 9)
    flat = torch.zeros(q.numel() + 1, device=cuda_device,
                       dtype=torch.bfloat16)
    shifted = flat[1:].view(q.shape)                     # base 2 bytes off
    wide = torch.zeros((2, 2, 64, 68), device=cuda_device,
                       dtype=torch.bfloat16)[..., :64]   # rows 136 bytes apart
    f = fa.flash_attention
    before = (f.launches, f.backward_launches)
    for bad in (shifted, wide):
        with pytest.raises(ValueError, match="16-byte"):
            f(bad, k, v, mask)
        with pytest.raises(ValueError, match="16-byte"):
            f(q, k, bad, mask)
    assert (f.launches, f.backward_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dims", FLASH_DIMS,
                         ids=lambda d: "B{}_N{}_S{}_D{}".format(*d))
def test_flash_bf16_keep_bits_equal_the_plain_packing(cuda_device, dims):
    """K8 writes the keep bits K9 reads in dropout_bits.tile_keep_bits'
    layout; the bf16 backward refuses to run at dropout without them."""
    from bert4rec_tpu_torch.ops import dropout_bits
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    q, k, v, mask, do = flash_operands(cuda_device, dims, torch.bfloat16, 10)
    _, saved = fa._launch_forward(q, k, v, mask, 12, 0.2, False, True)
    torch.cuda.synchronize()
    assert len(saved) == 3
    assert torch.equal(saved[2], dropout_bits.tile_keep_bits(
        12, *dims[:3], 0.2, cuda_device))
    with pytest.raises(ValueError, match="keep bits"):
        fa._launch_backward(q, k, v, mask, do, saved[:2], 12, 0.2, False)


# K10, the item table's gradient, at the two benchmark cells' batches:
# (R, V, H, [PAD] ids, [MASK] ids)
TABLE_GRAD_CELLS = {"ml20m_128": (51_200, 26_732, 128, 27_623, 4_630),
                    "bert_base_512": (16_384, 3_709, 768, 11_900, 2_432)}


def _table_grad_ids(device, r, v, pad, mask, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.exp(rng.uniform(0.0, np.log(v - 2), r)).astype(np.int32)
    at = rng.permutation(r)
    ids[at[:pad]] = 0
    ids[at[pad:pad + mask]] = v - 1
    return torch.from_numpy(ids).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TABLE_GRAD_CELLS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_table_grad_kernel_matches_plain(cuda_device, cell, dtype):
    """K10 against the plain fp32 version (float64 sums here). On
    integer-valued rows every sum is exact in fp32 whatever its order, so
    the kernel must equal it exactly: a dropped or doubled row shows. On
    random rows only the order of the fp32 adds differs: the error stays
    under depth * 2^-24 * (the row's sum of |g|), depth the kernel's
    longest chain of adds (32 in a piece, then 32 pieces or a thread
    group's tiles and the groups)."""
    from bert4rec_tpu_torch.ops import table_gradient as tg
    r, v, h, pad, mask = TABLE_GRAD_CELLS[cell]
    ids = _table_grad_ids(cuda_device, r, v, pad, mask)
    ints = torch.randint(-4, 5, (r, h), device=cuda_device).to(dtype)
    got = tg.table_gradient(ints, ids, v)
    assert got.dtype == torch.float32 and got.shape == (v, h)
    assert torch.equal(got.double(), tg.table_gradient_plain(
        ints.double(), ids, v))
    g = torch.randn((r, h), device=cuda_device).to(dtype)
    got = tg.table_gradient(g, ids, v).double()
    want = tg.table_gradient_plain(g.double(), ids, v)
    depth = 64 + max(32, -(-r // 32) // 8 + 1)   # tiles of 32 positions
    bound = depth * 2.0 ** -24 * tg.table_gradient_plain(
        g.double().abs(), ids, v)
    assert bool(((got - want).abs() <= bound).all())
    untouched = torch.ones(v, dtype=torch.bool, device=cuda_device)
    untouched[ids.long()] = False
    assert bool((got[untouched] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TABLE_GRAD_CELLS))
def test_table_grad_kernel_repeats_its_bits(cuda_device, cell):
    """No float atomics: two calls give the same bits."""
    from bert4rec_tpu_torch.ops import table_gradient as tg
    r, v, h, pad, mask = TABLE_GRAD_CELLS[cell]
    ids = _table_grad_ids(cuda_device, r, v, pad, mask, seed=1)
    g = torch.randn((r, h), device=cuda_device).to(torch.bfloat16)
    a = tg.table_gradient(g, ids, v)
    b = tg.table_gradient(g, ids, v)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("h, dtype", [
    (36, torch.bfloat16), (48, torch.bfloat16), (50, torch.float32),
    (64, torch.float32), (100, torch.float32), (256, torch.bfloat16),
    (2048, torch.bfloat16), (2048, torch.float32)])
@pytest.mark.parametrize("misaligned", [False, True])
def test_table_grad_kernel_at_any_width(cuda_device, h, dtype, misaligned):
    """Rows off the 16-byte rule (H not a multiple of the vector width, a
    misaligned base) take the scalar path; a ragged last tile; exact on
    integer-valued rows. H = 2,048 at the moonlight_5L cell's batch: R =
    12,800 rows over ML-20M's V = 26,732."""
    from bert4rec_tpu_torch.ops import table_gradient as tg
    r, v = (12_800, 26_732) if h == 2048 else (1_001, 97)
    ids = _table_grad_ids(cuda_device, r, v, 300, 80, seed=2)
    g = torch.randint(-4, 5, (r * h + 1,), device=cuda_device).to(dtype)
    g = (g[1:] if misaligned else g[:-1]).view(r, h)
    got = tg.table_gradient(g, ids, v)
    assert torch.equal(got.double(), tg.table_gradient_plain(
        g.double(), ids, v))


@pytest.mark.cuda
def test_table_grad_counts_one_launch_per_backward(cuda_device):
    from bert4rec_tpu_torch.ops import table_gradient as tg
    table = torch.randn(300, 64, device=cuda_device, requires_grad=True)
    ids = _table_grad_ids(cuda_device, 2_000, 300, 700, 200).view(10, 200)
    before = tg.table_gradient.launches
    for _ in range(3):
        y = tg.table_gather(table, ids, torch.bfloat16)
        torch.autograd.grad(y, table, torch.ones_like(y))
    assert tg.table_gradient.launches - before == 3
    with torch.no_grad():
        tg.table_gather(table, ids, torch.bfloat16)
    assert tg.table_gradient.launches - before == 3


# K12, the clip and AdamW update: leaves of 1, 7, 768 and 2^20 + 3 elements,
# a bf16 gradient (2^16 + 5), a zero gradient (300) and a leaf whose
# pointers are off the 16-byte rule (1,001 elements, scalar loads); the
# decay flag alternates
ADAMW_SIZES = (1, 7, 768, (1 << 20) + 3, (1 << 16) + 5, 300, 1_001)


def _adamw_leaves(device, grad_scale, seed=0):
    """(p, g, m, v) lists at ``ADAMW_SIZES``: random params, gradients
    times ``grad_scale``, the moments zero (``AdamW.init``'s: as in the
    optax test, the updates then stay near 1, which its bound assumes)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rand(n, scale=1.0):
        return (torch.randn(n, generator=gen) * scale).to(device)

    p = [rand(n) for n in ADAMW_SIZES]
    m = [torch.zeros(n, device=device) for n in ADAMW_SIZES]
    v = [torch.zeros(n, device=device) for n in ADAMW_SIZES]
    g = [rand(n, grad_scale) for n in ADAMW_SIZES]
    g[4] = g[4].to(torch.bfloat16)
    g[5] = torch.zeros_like(g[5])
    for x in (p, m, v, g):        # a view one element past a 16-byte base
        x[6] = torch.cat([x[6][:1], x[6]])[1:]
    return p, g, m, v


def _assert_adamw_close(kern, plain, lr):
    """Params within the optax test's bound, 1e-7 + lr 1e-5, its 1e-7 (the
    last rounding of a parameter near 1) taken as one unit in the last
    place of a larger one; moments within 1e-6 of their leaf's largest."""
    for a, b in zip(kern[0], plain[0]):
        ulp = torch.nextafter(b.abs(), torch.full_like(b, np.inf)) - b.abs()
        assert bool(((a - b).abs() <= ulp.clamp_min(1e-7) + lr * 1e-5)
                    .all()), float((a - b).abs().max())
    for a, b in zip(kern[2] + kern[3], plain[2] + plain[3]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("grad_scale", [3.0, 1e-4],
                         ids=["clipped", "unclipped"])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0],
                         ids=["decay", "no_decay"])
@pytest.mark.parametrize("warmup", [0, 2], ids=["warmup0", "warmup2"])
def test_adamw_kernels_match_plain(cuda_device, grad_scale, weight_decay,
                                   warmup):
    """Three updates through K12 against the plain chain, each from the
    same state (the chain's copies take K12's result before the next, so
    one update's rounding is held, not three compounded) and the chain
    clipping by K12's norm (which is held against a float64 norm):
    ``_assert_adamw_close``; three launches an update, none on the plain
    route."""
    from bert4rec_tpu_torch.ops import adamw
    from bert4rec_tpu_torch.trainers import optimizers
    opt = optimizers.create_adam_w_optimizer(
        init_lr=1e-2, num_train_steps=20, num_warmup_steps=warmup,
        weight_decay_rate=weight_decay)
    decay = [i % 2 == 0 for i in range(len(ADAMW_SIZES))]
    kern = list(_adamw_leaves(cuda_device, grad_scale))
    plain = [[t.clone() for t in x] for x in kern]
    norms = []
    for step in range(3):
        gs = _adamw_leaves(cuda_device, grad_scale, seed=step + 1)[1]
        kern[1], plain[1] = gs, [t.clone() for t in gs]
        hyper = opt.hyper(step)
        before = adamw.adamw_update.launches
        norm = adamw.adamw_update(*kern, decay, hyper)
        assert adamw.adamw_update.launches - before == 3
        adamw.adamw_update_plain(*plain, decay, hyper,
                                 sq_norm=lambda sums: norm * norm)
        assert adamw.adamw_update.launches - before == 3
        torch.cuda.synchronize()
        norms.append(float(torch.stack([t.double().square().sum()
                                        for t in gs]).sum().sqrt()))
        assert abs(float(norm) - norms[-1]) <= 1e-6 * norms[-1]
        _assert_adamw_close(kern, plain, hyper.lr)
        for i in (0, 2, 3):
            for a, b in zip(kern[i], plain[i]):
                b.copy_(a)
    assert (min(norms) > 5.0) if grad_scale > 1 else (max(norms) < 5.0)


@pytest.mark.cuda
def test_adamw_kernels_repeat_their_bits(cuda_device):
    """No float atomics: two runs of three updates from one start give the
    same params and moments, bit for bit, with the clip active."""
    from bert4rec_tpu_torch.ops import adamw
    from bert4rec_tpu_torch.trainers import optimizers
    opt = optimizers.create_adam_w_optimizer(init_lr=1e-2,
                                              num_warmup_steps=0)
    decay = [True] * len(ADAMW_SIZES)
    runs = []
    for _ in range(2):
        leaves = list(_adamw_leaves(cuda_device, 3.0))
        for step in range(3):
            leaves[1] = _adamw_leaves(cuda_device, 3.0, seed=step + 1)[1]
            adamw.adamw_update(*leaves, decay, opt.hyper(step))
        runs.append(leaves[0] + leaves[2] + leaves[3])
    torch.cuda.synchronize()
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(*runs))


@pytest.mark.cuda
def test_adamw_kernels_hand_the_hook_one_sum_a_leaf(cuda_device):
    """With ``sq_norm`` (a mesh) the hook gets one 0-d fp32 sum of squares
    a leaf, and the square root of what it returns clips: under a hook that
    doubles the squared norm, K12 and the plain chain (given K12's norm)
    agree by ``_assert_adamw_close``."""
    from bert4rec_tpu_torch.ops import adamw
    from bert4rec_tpu_torch.trainers import optimizers
    opt = optimizers.create_adam_w_optimizer(init_lr=1e-2,
                                             num_warmup_steps=0)
    decay = [True] * len(ADAMW_SIZES)
    kern = _adamw_leaves(cuda_device, 3.0)
    plain = [[t.clone() for t in x] for x in kern]
    seen = []

    def hook(sums):
        seen.append(sums)
        return 2 * torch.stack(sums).sum()

    hyper = opt.hyper(0)
    norm = adamw.adamw_update(*kern, decay, hyper, sq_norm=hook)
    again = adamw.adamw_update_plain(
        *plain, decay, hyper, sq_norm=lambda sums: (seen.append(sums),
                                                     norm * norm)[1])
    torch.cuda.synchronize()
    got, want = seen
    assert len(got) == len(ADAMW_SIZES)
    assert all(t.shape == () and t.dtype == torch.float32 and t.is_cuda
               for t in got)
    torch.testing.assert_close(torch.stack(got), torch.stack(want),
                               rtol=1e-6, atol=0)
    assert float(norm) == float((2 * torch.stack(got).sum()).sqrt())
    assert float(again) == float(norm)
    _assert_adamw_close(kern, plain, hyper.lr)


@pytest.mark.cuda
def test_adamw_kernels_past_2_to_the_31_elements(cuda_device):
    """Offsets past 2^31: one leaf of 2^31 + 2^20 + 3 elements (p, m, v
    fp32, g bf16: ~30 GB) and a leaf of 7 after it. Leaves that are views
    of one small buffer would race, since the update writes p, m and v in
    place, so the big leaf's content repeats with a period of 2^20 instead:
    every period's update must equal the first's bit for bit (the same
    inputs and arithmetic at any offset), its sum of squares the periods'
    sum, and the first period the plain chain's update under that norm."""
    from bert4rec_tpu_torch.ops import adamw
    from bert4rec_tpu_torch.trainers import optimizers
    period, reps = 1 << 20, (1 << 11) + 1
    n = period * reps + 3
    gen = torch.Generator(device="cpu").manual_seed(5)
    base_p = torch.randn(period, generator=gen).to(cuda_device)
    base_g = (torch.randn(period, generator=gen) * 1e-3).to(
        cuda_device, torch.bfloat16)

    def periodic(base, dtype):
        out = torch.empty(n, dtype=dtype, device=cuda_device)
        out[:period * reps].view(reps, period).copy_(base)
        out[period * reps:] = base[:3]
        return out

    p, g = periodic(base_p, torch.float32), periodic(base_g, torch.bfloat16)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    small = [torch.ones(7, device=cuda_device) for _ in range(4)]
    opt = optimizers.create_adam_w_optimizer(init_lr=1e-2,
                                             num_warmup_steps=0)
    hyper = opt.hyper(0)
    seen = []

    def hook(sums):
        seen.append(torch.stack(sums))
        return torch.stack(sums).sum()

    adamw.adamw_update([p, small[0]], [g, small[1]], [m, small[2]],
                       [v, small[3]], [True, True], hyper, sq_norm=hook)
    torch.cuda.synchronize()
    (sums,) = seen
    base_sq = base_g.double().square()
    want = reps * float(base_sq.sum()) + float(base_sq[:3].sum())
    assert abs(float(sums[0]) - want) <= 1e-5 * want
    assert float(sums[1]) == 7.0
    for x in (p, m, v):
        rows = x[:period * reps].view(reps, period)
        assert bool((rows == rows[0]).all())
        assert torch.equal(x[period * reps:], rows[0, :3])
    sq = float(sums.sum())
    ref = [base_p.clone(), base_g.clone(), torch.zeros_like(base_p),
           torch.zeros_like(base_p)]
    adamw.adamw_update_plain(*[[t] for t in ref], [True], hyper,
                             sq_norm=lambda s: torch.tensor(
                                 sq, device=cuda_device))
    _assert_adamw_close([[p[:period]], None, [m[:period]], [v[:period]]],
                        [[ref[0]], None, [ref[2]], [ref[3]]], hyper.lr)
    del p, g, m, v, rows
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_adamw_kernels_refuse_a_strided_param(cuda_device):
    from bert4rec_tpu_torch.ops import adamw
    p, g, m, v = (torch.zeros(8, 2, device=cuda_device) for _ in range(4))
    hyper = adamw.Hyper(lr=1e-3, bc1=0.1, bc2=1e-3, b1=0.9, b2=0.999,
                        eps=1e-6, weight_decay=0.0, clip=5.0)
    with pytest.raises(ValueError, match="contiguous"):
        adamw.adamw_update([p[:, 0]], [g[:, 0]], [m[:, 0]], [v[:, 0]],
                           [False], hyper)

# --------------------------------------------------------------------------- #
# latent attention's K8 / K9: queries and keys of 192, values of 128
# --------------------------------------------------------------------------- #

def wide_operands(device, b, n, s, seed):
    """q [B, N, S, 192], k as q, v [B, N, S, 128] laid out as the mla_moe
    block hands them over (q and k transposed views of [B, S, N, 192], v
    the last 128 columns of a [B, S, N, 256] projection), a mask from
    ``causal_mask_np`` and dO."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(device, torch.bfloat16)
    q, k = t(b, s, n, 192).transpose(1, 2), t(b, s, n, 192).transpose(1, 2)
    v = t(b, s, n, 256)[..., 128:].transpose(1, 2)
    mask = torch.from_numpy(causal_mask_np(rng, b, s)).to(device)
    return q, k, v, mask, t(b, n, s, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("bns", [(4, 2, 1), (4, 2, 65), (4, 3, 130),
                                 (64, 16, 200)],
                         ids=lambda d: "B{}_N{}_S{}".format(*d))
def test_flash_wide_keys_match_plain(cuda_device, bns):
    """K8 / K9 at (DK, DV) = (192, 128) against the plain versions, causal
    and bidirectional, dropout 0 and 0.2, at Moonlight's cell shape (B=64,
    N=16, S=200) among others: forward within 2e-2 absolute, gradients
    within 3e-2 of their scale (bf16's limits: sum-order differences flip
    bf16 roundings); dq and dk 192 wide, dv 128."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    q, k, v, mask, do = wide_operands(cuda_device, *bns, sum(bns))
    for causal, rate in ((True, 0.0), (False, 0.0), (True, 0.2)):
        o, saved = fa._launch_forward(q, k, v, mask, 5, rate, causal, True)
        grads = fa._launch_backward(q, k, v, mask, do, saved, 5, rate,
                                    causal)
        torch.cuda.synchronize()
        ref = fa.mha_reference(q, k, v, mask, rate, 5, causal)
        ref_grads = fa.flash_attention_plain_backward(
            q, k, v, mask, do, dropout_rate=rate, seed=5, causal=causal)
        label = f"causal={causal} rate={rate}"
        assert o.shape == (*q.shape[:3], 128), label
        assert float((o.float() - ref.float()).abs().max()) \
            <= FLASH_TOL[torch.bfloat16], label
        for name, got, want in zip("qkv", grads, ref_grads):
            assert got.shape == want.shape, (name, label)
            assert bool(torch.isfinite(got).all()), (name, label)
            assert _rel_err(got, want) <= GRAD_TOL[torch.bfloat16], \
                (name, label)


@pytest.mark.cuda
def test_flash_wide_keys_through_autograd_count_and_repeat(cuda_device):
    """``flash_attention`` at 192 / 128: one causal launch each way, the
    views' and their contiguous copies' bits equal, two K9 runs equal."""
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    q, k, v, mask, do = wide_operands(cuda_device, 4, 3, 130, 3)
    f = fa.flash_attention
    before = (f.causal_launches, f.causal_backward_launches)
    ts = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = f(*ts, mask, causal=True)
    out.backward(do)
    assert (f.causal_launches - before[0],
            f.causal_backward_launches - before[1]) == (1, 1)
    copies = [t.contiguous() for t in (q, k, v)]
    o1, s1 = fa._launch_forward(q, k, v, mask, 0, 0.0, True, True)
    o2, s2 = fa._launch_forward(*copies, mask, 0, 0.0, True, True)
    g1 = fa._launch_backward(q, k, v, mask, do, s1, 0, 0.0, True)
    g2 = fa._launch_backward(*copies, mask, do, s2, 0, 0.0, True)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(out.detach(), o1)
    for a, b, c in zip(g1, g2, (t.grad for t in ts)):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_flash_wide_keys_refuse_fp32_and_other_pairs(cuda_device):
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    q, k, v, mask, _ = wide_operands(cuda_device, 2, 2, 64, 4)
    with pytest.raises(ValueError):
        fa.flash_attention(q.float(), k.float(), v.float(), mask)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :160], k[..., :160], v, mask)


# --------------------------------------------------------------------------- #
# K11, the grouped expert GEMM
# --------------------------------------------------------------------------- #

def expert_operands(device, rows, h, i, counts, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32)).to(device)
    e = len(counts)
    return (t(rows, h).to(torch.bfloat16),
            torch.tensor(counts, dtype=torch.int32, device=device),
            t(e, h, i, scale=0.02), t(e, h, i, scale=0.02),
            t(e, i, h, scale=0.02), t(rows, h).to(torch.bfloat16))


def _cell_counts(rows=76_800, experts=64):
    """Moonlight's layer at the cell's batch (12,800 tokens x 6): a skewed
    split with two empty experts."""
    share = 1.0 / (1.0 + np.random.default_rng(1).permutation(experts)) \
        ** 0.6
    share[[5, 40]] = 0.0
    counts = np.floor(share / share.sum() * rows).astype(np.int64)
    counts[np.argmax(counts)] += rows - counts.sum()
    return counts.tolist()


EXPERT_CASES = {
    "moonlight": (76_800, 2048, 1408, _cell_counts()),
    "ragged": (1_001, 256, 200, [0, 1, 127, 128, 129, 0, 300, 316]),
    "one_expert": (130, 128, 192, [0, 0, 130, 0]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EXPERT_CASES))
def test_expert_gemm_kernels_match_plain(cuda_device, case):
    """K11 forward and backward against the plain version on uneven and
    empty experts: y, g, u, the activation and dx within 1e-2 of their
    scale, the fp32 weight gradients within 1e-2 (both sum the same bf16
    products in fp32 in another order, which can flip a bf16 rounding of
    g, u, dg or du by one unit, 2^-8); an empty expert's gradients 0."""
    from bert4rec_tpu_torch.ops import expert_gemm as eg
    rows, h, i, counts = EXPERT_CASES[case]
    x, c, wg, wu, wd, dy = expert_operands(cuda_device, rows, h, i, counts,
                                           rows)
    bf = [w.to(torch.bfloat16) for w in (wg, wu, wd)]
    got = eg._launch_forward(x, c, *bf)
    want = eg.expert_mlp_plain_forward(x, c, *bf)
    for name, a, b in zip(("y", "g", "u", "act"), got[:4], want):
        assert a.shape == b.shape and a.dtype == torch.bfloat16, name
        assert _rel_err(a, b) <= 1e-2, name
    grads = eg._launch_backward(dy, x, c, *bf, *got[1:4], got[4])
    ref = eg.expert_mlp_plain_backward(dy, x, c, *bf, *want[1:])
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dwg", "dwu", "dwd"), grads, ref):
        assert a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert _rel_err(a, b) <= 1e-2, name
    empty = [e for e, n in enumerate(counts) if n == 0]
    for g in grads[1:]:
        assert bool((g[empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "moonlight"])
def test_expert_gemm_autograd_counts_and_repeats(cuda_device, case):
    """``expert_mlp`` through autograd: one launch each way, fp32 weight
    gradients, the same bits from two runs (no atomics)."""
    from bert4rec_tpu_torch.ops import expert_gemm as eg
    rows, h, i, counts = EXPERT_CASES[case]
    x, c, wg, wu, wd, dy = expert_operands(cuda_device, rows, h, i, counts,
                                           9)
    runs = []
    for _ in range(2):
        before = (eg.expert_mlp.launches, eg.expert_mlp.backward_launches)
        xs = x.detach().requires_grad_(True)
        ws = [w.detach().requires_grad_(True) for w in (wg, wu, wd)]
        y = eg.expert_mlp(xs, c, *ws)
        y.backward(dy)
        assert (eg.expert_mlp.launches - before[0],
                eg.expert_mlp.backward_launches - before[1]) == (1, 1)
        assert all(w.grad.dtype == torch.float32 for w in ws)
        runs.append([y.detach(), xs.grad] + [w.grad for w in ws])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_expert_gemm_refuses_fp32_rows(cuda_device):
    from bert4rec_tpu_torch.ops import expert_gemm as eg
    x, c, wg, wu, wd, _ = expert_operands(cuda_device, 64, 128, 64,
                                          [32, 32], 2)
    with pytest.raises(ValueError):
        eg.expert_mlp(x.float(), c, wg, wu, wd)


@pytest.mark.cuda
def test_mla_moe_train_step_runs_the_kernels(cuda_device):
    """A small ``mla_moe`` SASRec trains through ``train_step`` on the card:
    flash attention at 192 / 128 once a layer each way, K11 once a MoE layer
    each way, no row dropped, the loss finite."""
    from bert4rec_tpu_torch.core.dtypes import DTypePolicy
    from bert4rec_tpu_torch.models import BERT4RecConfig, SASRecModel
    from bert4rec_tpu_torch.models.components import mla_moe
    from bert4rec_tpu_torch.ops import expert_gemm as eg
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    cfg = BERT4RecConfig(
        vocab_size=503, hidden_size=256, num_layers=3, num_attention_heads=2,
        inner_dim=512, max_sequence_length=64, max_predictions_per_seq=63,
        block="mla_moe", output_dropout=0.0, attention_dropout=0.0,
        use_flash_attention=True, n_routed_experts=8, num_experts_per_tok=2,
        moe_intermediate_size=128)
    trainer = BERT4RecTrainer(SASRecModel(config=cfg,
                                          dtype_policy=DTypePolicy.bf16()))
    trainer.initialize_model(seed=0, device=cuda_device)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 503, size=(8, 64)).astype(np.int32)
    lens = rng.integers(2, 65, size=8)
    mask = (np.arange(64)[None] < lens[:, None]).astype(np.int32)
    pos = np.tile(np.arange(63, dtype=np.int32), (8, 1))
    lab = np.where(pos < lens[:, None] - 1, ids[:, 1:], 0).astype(np.int32)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in dict(
        input_word_ids=ids * mask, input_mask=mask,
        masked_lm_positions=pos, masked_lm_ids=lab).items()}
    f, em = fa.flash_attention, eg.expert_mlp
    before = (f.causal_launches, f.causal_backward_launches, em.launches,
              em.backward_launches)
    mla_moe.routing_counts.reset()
    logs = trainer.train_step(batch)
    after = (f.causal_launches, f.causal_backward_launches, em.launches,
             em.backward_launches)
    assert [a - b for a, b in zip(after, before)] == [3, 3, 2, 2]
    assert bool(torch.isfinite(logs["loss"]))
    counts = mla_moe.routing_counts.read()
    assert counts["routed_rows"] == 2 * 8 * 64 * 2
    assert counts["dropped_rows"] == 0


# --------------------------------------------------------------------------- #
# the kernels a launch runs, by the profiler's names
# --------------------------------------------------------------------------- #

def _traced(fn, want):
    """``(names, want, out)``: the device kernels' names in a torch.profiler
    trace of ``fn()`` after one call untraced, traced again (up to three
    times: the profiler can drop records) while one of ``want`` is
    missing, and what that last call returned."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if getattr(e, "self_device_time_total", 0) > 0]
        if all(any(k in n for n in names) for k in want):
            break
    return names, want, out


def _tiled_fp32_launches(device, w, kernel, v):
    """fp32 K5 (both entries), K6 or K7: [(launch, kernels it must run)]."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    h, t, b, lab, _ = _tiled_inputs(device, torch.float32, 1000, v, w)
    if kernel == "K5":
        return [(lambda: fml._launch_forward_tiled(h, t, b, lab),
                 {"loss_tf32_fwd_sweep_kernel<", "loss_tiled_merge_kernel",
                  "reduce_rows_kernel"}),
                (lambda: fml._launch_forward_tiled_stats(h, t, b, lab),
                 {"loss_tf32_fwd_sweep_kernel<", "loss_tiled_merge_kernel"})]
    merged = kernel == "K6"
    lse, sums = fml._launch_forward_tiled(h, t, b, lab)
    g = torch.ones((), device=device)
    return [(lambda: fml._launch_backward_tiled(
        h, t, b, lab, lse, g, sums[3:4], merged),
        {"loss_tf32_merged_kernel<", "reduce_rows_cast_kernel<float>"}
        if merged else {"loss_tf32_sweep_kernel<", "false>", "true>"})]


def _whole_table_fp32_launches(device, w):
    """fp32 K3 and K4 at R = 1,000, V = 3,000."""
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    h, t, b, lab, _ = _tiled_inputs(device, torch.float32, 1000, 3000, w)
    lse, sums = fml._launch_forward(h, t, b, lab)
    g = torch.ones((), device=device)
    return [(lambda: fml._launch_forward(h, t, b, lab),
             {"loss_tf32_fwd_sweep_kernel<", "loss_tiled_merge_kernel",
              "reduce_rows_kernel"}),
            (lambda: fml._launch_backward(h, t, b, lab, lse, g, sums[3:4]),
             {"loss_tf32_sweep_kernel<", "false>", "true>"})]


# the benchmark cells' routes at two layers (tests/test_torch_spans.py's)
TABLE_GRAD_ROUTES = {
    "fused_layer": dict(hidden_size=128, num_attention_heads=4,
                        inner_dim=512, seq=200, pred=40, batch=32),
    "flash_attention": dict(hidden_size=768, num_attention_heads=12,
                            inner_dim=3072, seq=512, pred=76, batch=4,
                            use_fused_layer=False, use_fused_loss=False,
                            use_flash_attention=True)}


def _train_launches(device, route):
    """A bf16 ``train()`` of three steps at ``TABLE_GRAD_ROUTES[route]``,
    returning the K10 and K12 launches it counted."""
    from bert4rec_tpu_torch.core.dtypes import DTypePolicy
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset)
    from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
    from bert4rec_tpu_torch.ops import adamw
    from bert4rec_tpu_torch.ops import table_gradient as tg
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer
    kw = dict(TABLE_GRAD_ROUTES[route])
    seq, pred, batch = kw.pop("seq"), kw.pop("pred"), kw.pop("batch")
    vocab, steps = 515, 3
    cfg = dict(vocab_size=vocab, num_layers=2, max_sequence_length=seq,
               max_predictions_per_seq=pred, attention_dropout=0.1,
               output_dropout=0.1, use_fused_layer=True, use_fused_loss=True)
    cfg.update(kw)
    rng = np.random.default_rng(0)
    seqs = [rng.integers(3, vocab, size=rng.integers(4, seq + 1))
            .astype(np.int32) for _ in range(steps * batch)]
    ds = ProcessedDataset(seqs, MaskingConfig(
        max_seq_len=seq, max_predictions_per_seq=pred, mask_token_id=1,
        pad_token_id=0, unk_token_id=2, masked_lm_rate=0.3), lambda: vocab)
    t = BERT4RecTrainer(BERT4RecModel(config=BERT4RecConfig(**cfg),
                                      dtype_policy=DTypePolicy.bf16()))
    t.initialize_model(seed=0, device=device)

    def run():
        before = tg.table_gradient.launches, adamw.adamw_update.launches
        t.train(ds, epochs=1, batch_size=batch, verbose=False)
        return (tg.table_gradient.launches - before[0],
                adamw.adamw_update.launches - before[1])

    return [(run, {"b4r::table_grad", "b4r::adamw"})]


def _fp32_layer_launches(device, variant):
    """An fp32 training forward with dropout (saving for its backward) and
    its backward, plain, causal or with a relative bias."""
    _, p, xt, mt, dy, kw = _fp32_train_step(device, (4, 200, 128, 4, 512),
                                            causal=variant == "causal",
                                            rel=variant == "rel")
    flat = {k: v.detach() for k, v in fel.flat_weights(p).items()}
    launch = dict(causal=kw["causal"], rel=kw.get("rel_bias"))

    def run():
        _, saved = fel._launch_forward(flat, xt.detach(), mt, 4, 9, 0.1, 0.1,
                                       True, **launch)
        return fel._launch_backward(flat, xt.detach(), mt, dy, saved, 4, 9,
                                    0.1, 0.1, **launch)

    return [(run, ("attn_tf32_kernel<", "attn_dq_tf32_kernel<",
                   "attn_dkv_tf32_kernel<", "wgrad_tf32_kernel",
                   "ln_rows_bwd_kernel<"))]


TILED_ROUTES = [(128, "K6", 3000), (256, "K7", 3000), (256, "K6", 3000),
                (128, "K7", 3000), (40, "K6", 3000), (40, "K7", 3000),
                (64, "K5", 3000), (128, "K5", 3000), (256, "K5", 3000),
                (128, "K5", 335424)]
ROUTE_TRACES = {**{("tiled", c): (_tiled_fp32_launches, *c)
                   for c in TILED_ROUTES},
                **{("whole_table", w): (_whole_table_fp32_launches, w)
                   for w in (128, 64, 256)},
                **{("train", r): (_train_launches, r)
                   for r in sorted(TABLE_GRAD_ROUTES)},
                **{("fp32_layer", v): (_fp32_layer_launches, v)
                   for v in ("plain", "causal", "rel")}}


@pytest.fixture(scope="module", autouse=True)
def traces():
    """Every trace of the tests below, ``{key: [(names, want, out)]}`` by
    ``ROUTE_TRACES``, taken at this module's first test, before any other
    launch: in a process that had traced once and launched much since, a
    later trace came up short of records. So no order or selection of the
    tests moves a trace. A setup's error is kept for its test to raise."""
    out = {}
    if not torch.cuda.is_available():
        return out
    torch.backends.cuda.matmul.allow_tf32 = False
    for key, (setup, *args) in ROUTE_TRACES.items():
        try:
            out[key] = [_traced(fn, want)
                        for fn, want in setup(torch.device("cuda"), *args)]
        except Exception as err:   # noqa: BLE001
            out[key] = err
    return out


def _read(traces, key):
    if isinstance(traces[key], Exception):
        raise traces[key]
    return traces[key]


@pytest.mark.cuda
@pytest.mark.parametrize("w,kernel,v", TILED_ROUTES, ids=lambda v: str(v))
def test_tiled_fp32_launch_runs_only_the_tf32_kernels(cuda_device, traces,
                                                      w, kernel, v):
    """An fp32 K6 launch runs loss_tf32.cuh's merged kernel and the ordered
    dh reduction, an fp32 K7 launch its two sweeps (dh, then dt); neither
    reaches the SIMT sweeps they replaced (``loss_bwd_vt_kernel``, and for
    K7 ``loss_bwd_dh_kernel``, since gone from the source with fp32 K4's
    SIMT tiles). An fp32 K5 launch, either entry, at each width and at
    Reddit's vocabulary, runs only loss_tf32.cuh's forward sweep, the
    ordered merge and (the loss entry) the row sums: no route back to the
    SIMT tiles (``loss_tiled_fwd_kernel``, gone from the source)."""
    if kernel == "K5":
        allowed = ("loss_tf32_fwd_sweep_kernel<", "loss_tiled_merge_kernel",
                   "reduce_rows_kernel")
        forbid = ("loss_tiled_fwd_kernel", "loss_fwd_kernel")
    else:
        allowed = ("loss_tf32", "reduce_rows_cast_kernel<float>")
        forbid = ("loss_bwd_vt_kernel",) + (
            () if kernel == "K6" else ("loss_bwd_dh_kernel",))
    for names, want, _ in _read(traces, ("tiled", (w, kernel, v))):
        assert not [n for n in names if any(f in n for f in forbid)], names
        assert all(any(k in n for n in names) for k in want), names
        assert all(any(a in n for a in allowed) for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("w", [128, 64, 256])
def test_fp32_whole_table_launch_runs_only_the_tf32_kernels(cuda_device,
                                                           traces, w):
    """An fp32 K3 launch runs loss_tf32.cuh's forward sweep, the ordered
    merge and the row sums; an fp32 K4 launch fp32 K7's two sweeps (dh,
    then dt). Neither reaches a SIMT loss kernel."""
    for k, (names, want, _) in zip(("K3", "K4"),
                                   _read(traces, ("whole_table", w))):
        assert all(any(x in n for n in names) for x in want), (k, names)
        assert all("loss_tf32" in n or "loss_tiled_merge_kernel" in n
                   or "reduce_rows_kernel" in n for n in names), (k, names)


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(TABLE_GRAD_ROUTES))
def test_train_steps_take_the_table_grad_kernel(cuda_device, traces, route):
    """A traced ``train()`` holds ``b4r::table_grad`` kernels and no
    ``indexing_backward_kernel`` (the MLM head's position gather is
    ``torch.gather``, so the item table is the only indexed gather with a
    gradient), and ``table_gradient.launches`` equals the steps trained.
    The update is K12's: ``b4r::adamw`` kernels, no foreach
    ``multi_tensor_apply_kernel``, three launches a step."""
    (names, _, moved), = _read(traces, ("train", route))
    assert moved == (3, 3 * 3)
    assert not [n for n in names if "indexing_backward" in n], names
    assert any("b4r::table_grad_combine" in n for n in names), names
    assert not [n for n in names if "multi_tensor_apply" in n], names
    assert any("adamw_update_kernel" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "causal", "rel"])
def test_fp32_training_launch_runs_only_the_tf32_kernels(cuda_device,
                                                        traces, variant):
    """An fp32 training forward with dropout (saving for its backward) and
    its backward run csrc/layer_tf32.cu's 3xTF32 kernels (and the ordered
    row sums) only: no SIMT layer kernel, by the profiler's kernel
    names."""
    (names, want, _), = _read(traces, ("fp32_layer", variant))
    assert not [n for n in names
                if any(k in n for k in SIMT_FP32_LAYER_KERNELS)], names
    assert all(any(k in n for n in names) for k in want), names
    layer = [n for n in names if "tf32" in n or "split" in n
             or "ln_rows" in n or "colsum" in n]
    assert all(any(k in n for k in TF32_LAYER_KERNELS) for n in layer), names
