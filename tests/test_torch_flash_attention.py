"""The port's flash attention (bert4rec_tpu_torch/ops/flash_attention.py)
and the paths that reach it, held against the JAX package on the CPU.

The plain versions of K8/K9 against JAX's ``flash_attention`` run in
interpret mode at rate 0 (forward and the q/k/v gradients, bidirectional
and causal, with ragged lengths, a length-1 row and an all-pad row);
dropout, which JAX cannot run there (interpret mode stubs its PRNG), by its
own laws: the keep rate, one mask in the forward and the backward, a new
mask for a new seed, and float64 finite differences. Then the encoder with
``use_flash_attention`` (post-LN and pre-LN), SASRec on flash, ``remat``
and ``output_range`` against JAX, the reference-default encoder's param
structure, and one train step on flash against the JAX trainer. The CUDA
kernels themselves are held against the plain versions on a card in
tests/test_torch_cuda_kernels.py."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models import BERT4RecModel as JaxModel
from bert4rec_tpu.models import SASRecModel as JaxSASRec
from bert4rec_tpu.ops.flash_attention import flash_attention as jax_flash
from bert4rec_tpu_torch.models import (
    BERT4RecConfig, BERT4RecModel, Bert4RecEncoder, SASRecModel,
)
from bert4rec_tpu_torch.ops import dropout_bits, tf32
from bert4rec_tpu_torch.utils import checkpoint
from bert4rec_tpu_torch.utils.checkpoint import flatten, params_from_numpy
from tests.test_torch_model import features, model_kwargs, random_params
from tests.test_torch_model import to_jax
from tests import test_torch_trainer as tt

# the module: the package exports its function under the same name
fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")

# the JAX package's flash tolerances (tests/ops_tests/test_ops.py:28-56)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def qkv_np(seed=0, b=3, n=4, s=70, d=16, lengths=(70, 1, 0)):
    """q, k, v ``[B, N, S, D]`` and an int32 mask: a full row, a row of
    length 1 and an all-pad row by default."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, n, s, d)).astype(np.float32)
               for _ in range(3))
    lengths = np.asarray(lengths)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return q, k, v, mask


def port_run(q, k, v, mask, g=None, dtype=torch.float32, **kw):
    """The port's output, and its q/k/v gradients for cotangent ``g``."""
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(g is not None)
          for a in (q, k, v)]
    out = fa.flash_attention(*ts, torch.from_numpy(mask), **kw)
    if g is None:
        return out, None
    (out.float() * torch.from_numpy(g)).sum().backward()
    return out, [t.grad for t in ts]


def jax_run(q, k, v, mask, g=None, dtype=jnp.float32, **kw):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    m = jnp.asarray(mask)
    out = jax_flash(*args, m, interpret=True, **kw)
    if g is None:
        return out, None
    grads = jax.grad(lambda *a: jnp.sum(
        jax_flash(*a, m, interpret=True, **kw).astype(jnp.float32)
        * jnp.asarray(g)), argnums=(0, 1, 2))(*args)
    return out, grads


class TestPlainVersusJaxKernel:

    @pytest.mark.parametrize("causal", [False, True],
                             ids=["bidirectional", "causal"])
    def test_fp32_forward_and_grads_match_interpret_kernel(self, causal):
        q, k, v, mask = qkv_np(1)
        g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
        out, grads = port_run(q, k, v, mask, g, causal=causal)
        ref, ref_grads = jax_run(q, k, v, mask, g, causal=causal)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   **FWD_TOL)
        for a, b in zip(grads, ref_grads):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)

    @pytest.mark.parametrize("causal", [False, True],
                             ids=["bidirectional", "causal"])
    def test_bf16_matches_interpret_kernel(self, causal):
        q, k, v, mask = qkv_np(3, lengths=(70, 33, 1))
        out, _ = port_run(q, k, v, mask, dtype=torch.bfloat16, causal=causal)
        ref, _ = jax_run(q, k, v, mask, dtype=jnp.bfloat16, causal=causal)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), **BF16_TOL)

    def test_all_pad_and_length_one_rows_follow_the_law(self):
        """An all-pad row attends uniformly to every key (to keys j <= i
        when causal); a length-1 row sees only its first key."""
        q, k, v, mask = qkv_np(4)
        vt = torch.from_numpy(v)
        out, _ = port_run(q, k, v, mask)
        np.testing.assert_allclose(
            out[2].numpy(), vt[2].mean(dim=1, keepdim=True)
            .expand(-1, 70, -1).numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            out[1].numpy(), vt[1, :, :1].expand(-1, 70, -1).numpy(),
            rtol=1e-5, atol=1e-5)
        causal, _ = port_run(q, k, v, mask, causal=True)
        prefix_mean = vt[2].cumsum(dim=1) / torch.arange(1, 71)[:, None]
        np.testing.assert_allclose(causal[2].numpy(), prefix_mean.numpy(),
                                   rtol=1e-5, atol=1e-5)

    def test_causal_future_independence(self):
        """Row i of the output sees no key or value at j > i."""
        q, k, v, mask = qkv_np(5, lengths=(70, 50, 20))
        out1, _ = port_run(q, k, v, mask, causal=True)
        k2, v2 = k.copy(), v.copy()
        k2[:, :, 12:] += 3.0
        v2[:, :, 12:] += 3.0
        out2, _ = port_run(q, k2, v2, mask, causal=True)
        np.testing.assert_allclose(out1[:, :, :12].numpy(),
                                   out2[:, :, :12].numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert float((out1 - out2).abs().max()) > 1e-2

    def test_cpu_wrapper_runs_plain_and_counts_no_launch(self):
        q, k, v, mask = qkv_np(6)
        f = fa.flash_attention
        before = (f.launches, f.backward_launches, f.causal_launches,
                  f.causal_backward_launches)
        out, grads = port_run(q, k, v, mask, np.ones_like(q))
        assert (f.launches, f.backward_launches, f.causal_launches,
                f.causal_backward_launches) == before
        ts = [torch.from_numpy(a) for a in (q, k, v)]
        assert torch.equal(out.detach(), fa.mha_reference(
            *ts, torch.from_numpy(mask)))
        plain = fa.flash_attention_plain_backward(
            *ts, torch.from_numpy(mask), torch.ones_like(ts[0]))
        for a, b in zip(grads, plain):
            assert torch.equal(a, b)

    def test_sequences_past_the_jax_limit_run_the_plain_version(
            self, monkeypatch):
        """JAX's shape law, kept for CPU tensors: past MAX_FUSED_SEQ_LEN
        the plain version runs, differentiated by autograd, not the
        kernels' Function (a CUDA tensor launches the kernels at every S
        up to MAX_KERNEL_SEQ_LEN: tests/test_torch_cuda_kernels.py)."""
        q, k, v, mask = qkv_np(7, s=20, lengths=(20, 9, 3))
        monkeypatch.setattr(fa, "MAX_FUSED_SEQ_LEN", 16)
        calls = []
        monkeypatch.setattr(fa._FlashAttention, "apply",
                            lambda *a: calls.append(a))
        out, grads = port_run(q, k, v, mask, np.ones_like(q))
        assert calls == [] and all(g is not None for g in grads)
        ref, _ = jax_run(q, k, v, mask)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   **FWD_TOL)

    def test_operands_are_checked(self):
        q, k, v, mask = (torch.from_numpy(a) for a in qkv_np(8))
        with pytest.raises(ValueError):
            fa.flash_attention(q, k[:, :, :10], v, mask)
        with pytest.raises(ValueError):
            fa.flash_attention(q, k, v, mask[:, :10])
        with pytest.raises(TypeError):
            fa.flash_attention(q, k.half(), v, mask)
        with pytest.raises(ValueError):   # one dropout site per head
            wide = torch.zeros((1, 65, 4, 8))
            fa.flash_attention(wide, wide, wide, torch.ones((1, 4)),
                               dropout_rate=0.1, seed=1)


class TestKernelLayoutRule:
    """What the bf16 kernels take, decided in Python before any launch (the
    kernels themselves run on a card: tests/test_torch_cuda_kernels.py)."""

    @staticmethod
    def projection_views(b=2, s=5, n=3, d=16, dtype=torch.bfloat16):
        proj = torch.zeros((b, s, 3, n, d), dtype=dtype)
        return [proj[:, :, i].transpose(1, 2) for i in range(3)]

    def test_the_main_paths_views_and_contiguous_operands_pass(self):
        for t in self.projection_views() + [torch.zeros((2, 3, 5, 16),
                                                        dtype=torch.bfloat16)]:
            fa.check_copy_alignment(t, "q")

    @pytest.mark.parametrize("case", ["base", "sequence", "head"])
    def test_a_misaligned_operand_is_refused(self, case):
        if case == "base":
            t = torch.zeros(2 * 3 * 5 * 16 + 1, dtype=torch.bfloat16)[1:] \
                .view(2, 3, 5, 16)
        elif case == "sequence":   # rows 40 bytes apart
            t = torch.zeros((2, 3, 5, 20), dtype=torch.bfloat16)
        else:                      # heads 20 elements (40 bytes) apart
            t = torch.zeros((2, 5, 4, 20), dtype=torch.bfloat16) \
                .transpose(1, 2)[..., :16]
        what = "base address" if case == "base" else f"{case} stride"
        with pytest.raises(ValueError, match=f"16-byte.*{what}"):
            fa.check_copy_alignment(t, "k")

    def test_axes_of_size_one_are_not_stepped(self):
        t = torch.zeros((1, 1, 1, 16), dtype=torch.bfloat16).as_strided(
            (1, 1, 1, 16), (3, 5, 7, 1))
        fa.check_copy_alignment(t, "q")
        assert fa.head_strides(t) == (0, 0, 0)
        assert fa.head_strides(torch.zeros((2, 3, 5, 16))) == (240, 80, 16)

    def test_the_wrapper_refuses_before_reaching_the_kernels(
            self, monkeypatch):
        def no_kernels():
            raise AssertionError("the kernel library was reached")
        monkeypatch.setattr(fa, "_kernel_lib", no_kernels)
        q, k, v = self.projection_views()
        mask = torch.ones((2, 5), dtype=torch.int32)
        bad = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:] \
            .view(q.shape)
        with pytest.raises(ValueError, match="16-byte"):
            fa._launch_forward(q, k, bad, mask, 3, 0.2, False, True)
        stats = (torch.zeros((2, 3, 5)), torch.ones((2, 3, 5)))
        with pytest.raises(ValueError, match="keep bits"):
            fa._launch_backward(q, k, v, mask, torch.zeros_like(q), stats,
                                3, 0.2, False)

    @pytest.mark.parametrize("seq_len", [1, 64, 130])
    def test_keep_bits_pack_the_keep_scale_mask(self, seq_len):
        """dropout_bits.tile_keep_bits against keep_scale: each word holds
        its wgmma thread's 32 (query, key) pairs at bit 4 j + 2 h + e."""
        b, n, seed, rate = 2, 3, 17, 0.2
        words = dropout_bits.tile_keep_bits(seed, b, n, seq_len, rate, "cpu")
        t = dropout_bits.tiles(seq_len)
        assert words.shape == (b, n, t, t, 128) and words.dtype == torch.int32
        w = words.to(torch.int64) & 0xFFFFFFFF
        unpacked = torch.zeros((b, n, 64 * t, 64 * t), dtype=torch.bool)
        thread = torch.arange(128)
        warp, g, c = thread // 32, thread % 32 // 4, thread % 4
        for j in range(8):
            for h in range(2):
                for e in range(2):
                    bit = (w >> (4 * j + 2 * h + e)) & 1
                    for qt in range(t):
                        for kt in range(t):
                            unpacked[:, :, 64 * qt + 16 * warp + g + 8 * h,
                                     64 * kt + 8 * j + 2 * c + e] = \
                                bit[:, :, qt, kt].bool()
        keep = dropout_bits.keep_scale(seed, b, range(n), seq_len, seq_len,
                                       rate, "cpu") > 0
        assert torch.equal(unpacked[:, :, :seq_len, :seq_len], keep)


class TestDropout:

    RATE = 0.2

    def test_keep_rate_and_scale(self):
        keep = fa.attention_keep(11, 3, 4, 70, self.RATE, "cpu")
        assert keep.shape == (3, 4, 70, 70)
        assert set(torch.unique(keep).tolist()) == {0.0, 1.0 / 0.8}
        assert abs(float((keep > 0).float().mean()) - 0.8) < 5e-3
        # the layer kernels' law: site h per head, counter row * S + col
        assert torch.equal(keep, dropout_bits.keep_scale(
            11, 3, range(4), 70, 70, self.RATE, "cpu"))

    def test_forward_applies_the_mask_to_the_probabilities(self):
        q, k, v, mask = (torch.from_numpy(a) for a in qkv_np(9))
        out = fa.flash_attention(q, k, v, mask, self.RATE, seed=11)
        keep = fa.attention_keep(11, 3, 4, 70, self.RATE, "cpu")
        p = torch.softmax(q @ k.transpose(-1, -2) / 4.0 + torch.where(
            mask > 0, 0.0, -1e9)[:, None, None, :], dim=-1)
        np.testing.assert_allclose(out.numpy(), ((p * keep) @ v).numpy(),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("causal", [False, True],
                             ids=["bidirectional", "causal"])
    def test_backward_uses_the_forward_mask(self, causal):
        """The plain K9 equals autograd through the plain K8 with the same
        seed: one mask in both."""
        q, k, v, mask = qkv_np(10, lengths=(70, 40, 0))
        g = np.random.default_rng(3).normal(size=q.shape).astype(np.float32)
        _, grads = port_run(q, k, v, mask, g, dropout_rate=self.RATE,
                            seed=5, causal=causal)
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = fa.mha_reference(*ts, torch.from_numpy(mask), self.RATE, 5,
                               causal)
        ref = torch.autograd.grad(out, ts, torch.from_numpy(g))
        for a, b in zip(grads, ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-5)

    def test_seed_selects_the_mask(self):
        q, k, v, mask = qkv_np(11)
        a, _ = port_run(q, k, v, mask, dropout_rate=self.RATE, seed=1)
        b, _ = port_run(q, k, v, mask, dropout_rate=self.RATE, seed=1)
        c, _ = port_run(q, k, v, mask, dropout_rate=self.RATE, seed=2)
        plain, _ = port_run(q, k, v, mask)
        none, _ = port_run(q, k, v, mask, dropout_rate=self.RATE)
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert float((a - plain).abs().max()) > 1e-2
        assert torch.equal(none, plain)   # no seed, no dropout

    @pytest.mark.parametrize("causal", [False, True],
                             ids=["bidirectional", "causal"])
    def test_gradcheck_float64(self, causal):
        # no all-pad row: its scores sit at -1e9, where a finite
        # difference of 1e-6 is a few float64 ulps
        q, k, v, mask = qkv_np(12, b=2, n=2, s=9, d=4, lengths=(9, 4))
        ts = [torch.from_numpy(a).double().requires_grad_(True)
              for a in (q, k, v)]
        m = torch.from_numpy(mask)
        assert torch.autograd.gradcheck(
            lambda *a: fa.flash_attention(*a, m, self.RATE, seed=3,
                                          causal=causal), ts)


# --------------------------------------------------------------------------- #
# the fp32 3xTF32 kernels' arithmetic (csrc/flash_tf32.cuh) and the route law
# --------------------------------------------------------------------------- #

TILE = 64   # the kernels' key / query tile


def three_tf32_flash(q, k, v, mask, do, *, rate=0.0, seed=0, causal=False,
                     mm=tf32.mm_3xtf32, corrected=True):
    """The 3xTF32 kernels' arithmetic in plain PyTorch, every product
    through ``mm``: K8's one online pass over 64-key tiles (the running max
    and sum, the unnormalised exponentials scaled by keep after they join
    the sum, o divided by the sum at the end; the row max and sum saved),
    and K9 from those statistics: the dq kernel's ds0 with delta0 = dO . o,
    JAX's delta = sum_j p dp keep beside it, dq = dq0 - (delta - delta0)
    sum_j p k (``corrected``; without, dq = dq0 and dk from delta0), the
    dk / dv kernel's ds from JAX's delta. Returns ``(o, dq, dk, dv)``."""
    b, n, s, d = q.shape
    scale = 1.0 / np.sqrt(d)
    bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :].expand(
        b, n, s, s)
    if causal:
        bias = bias + fa.causal_bias(s, "cpu")
    keep = fa.attention_keep(seed, b, n, s, rate, "cpu")
    keep = torch.ones((b, n, s, s)) if keep is None else keep
    log2e = float(np.log2(np.e))
    o = torch.zeros((b, n, s, d))
    m = torch.full((b, n, s, 1), -np.inf)
    lsum = torch.zeros((b, n, s, 1))
    for t0 in range(0, s, TILE):
        kt, vt = k[:, :, t0:t0 + TILE], v[:, :, t0:t0 + TILE]
        st = mm(q, kt.transpose(-1, -2)) * scale + bias[..., t0:t0 + TILE]
        mn = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp2((m - mn) * log2e)
        e = torch.exp2((st - mn) * log2e)
        lsum = lsum * alpha + e.sum(-1, keepdim=True)
        o = o * alpha + mm(e * keep[..., t0:t0 + TILE], vt)
        m = mn
    o = o * (1.0 / lsum)
    delta0 = (do * o).sum(-1, keepdim=True)
    p = torch.exp2((mm(q, k.transpose(-1, -2)) * scale + bias - m) * log2e) \
        * (1.0 / lsum)
    dpk = mm(do, v.transpose(-1, -2)) * keep
    delta = (p * dpk).sum(-1, keepdim=True) if corrected else delta0
    dq = mm(p * (dpk - delta0), k)
    if corrected:
        dq = dq - (delta - delta0) * mm(p, k)
    dq = dq * scale
    ds = p * (dpk - delta)
    dk = mm(ds.transpose(-1, -2), q) * scale
    dv = mm((p * keep).transpose(-1, -2), do)
    return o, dq, dk, dv


def scale_err(a, b) -> float:
    """max |a - b| over the scale max |b|."""
    return float((a - b).abs().max() / b.abs().max())


class TestThreeTf32Flash:
    """fp32 K8/K9's 3xTF32 arithmetic, emulated with ``ops/tf32.py``, held
    to JAX's fp32 flash attention (interpret mode) and to the plain fp32
    versions with dropout. Shapes: S=70 (a ragged second key tile), D=16,
    a full row, a row of length 1 and an all-pad row."""

    @staticmethod
    def operands(seed, lengths=(70, 1, 0)):
        q, k, v, mask = qkv_np(seed, lengths=lengths)
        g = np.random.default_rng(seed + 100).normal(size=q.shape) \
            .astype(np.float32)
        return q, k, v, mask, g

    @pytest.mark.parametrize("causal", [False, True],
                             ids=["bidirectional", "causal"])
    def test_matches_the_interpret_kernel(self, causal):
        q, k, v, mask, g = self.operands(21)
        ref, ref_grads = jax_run(q, k, v, mask, g, causal=causal)
        out = three_tf32_flash(*(torch.from_numpy(a) for a in
                                 (q, k, v, mask, g)), causal=causal)
        assert float(np.abs(out[0].numpy() - np.asarray(ref)).max()) <= 1e-4
        for a, b in zip(out[1:], ref_grads):
            assert scale_err(a, torch.from_numpy(np.array(b))) <= 3e-4

    @pytest.mark.parametrize("causal", [False, True],
                             ids=["bidirectional", "causal"])
    def test_matches_the_plain_versions_with_dropout(self, causal):
        q, k, v, mask, g = (torch.from_numpy(a) for a in
                            self.operands(22, lengths=(70, 40, 0)))
        out = three_tf32_flash(q, k, v, mask, g, rate=0.2, seed=9,
                               causal=causal)
        ref = fa.mha_reference(q, k, v, mask, 0.2, 9, causal)
        ref_grads = fa.flash_attention_plain_backward(
            q, k, v, mask, g, dropout_rate=0.2, seed=9, causal=causal)
        assert float((out[0] - ref).abs().max()) <= 1e-5
        for a, b in zip(out[1:], ref_grads):
            assert scale_err(a, b) <= 1e-5

    @pytest.mark.parametrize("rate", [0.0, 0.2], ids=["rate0", "dropout"])
    def test_a_row_on_one_key_gets_zero_q_and_k_gradients(self, rate):
        """Where a row's probability is all on one key (S = 1), ds is 0 in
        exact arithmetic and in the plain version; the kernels' corrected
        delta keeps dq, dk at rounding noise of ~1e-13, where dO . o alone
        leaves ~1e-7 (the plain fp32 path's own dq, dk are exactly 0)."""
        q, k, v, mask = (torch.from_numpy(a) for a in qkv_np(
            25, b=4, s=1, lengths=(1, 1, 0, 1)))
        g = torch.from_numpy(np.random.default_rng(26).normal(
            size=q.shape).astype(np.float32))
        plain = fa.flash_attention_plain_backward(q, k, v, mask, g,
                                                  dropout_rate=rate, seed=3)
        assert float(plain[0].abs().max()) == float(plain[1].abs().max()) \
            == 0.0
        fixed = three_tf32_flash(q, k, v, mask, g, rate=rate, seed=3)
        raw = three_tf32_flash(q, k, v, mask, g, rate=rate, seed=3,
                               corrected=False)
        assert max(float(t.abs().max()) for t in fixed[1:3]) <= 1e-11
        assert max(float(t.abs().max()) for t in raw[1:3]) >= 1e-9

    def test_one_tf32_pass_lands_an_order_of_magnitude_further_off(self):
        q, k, v, mask, g = (torch.from_numpy(a) for a in self.operands(23))
        ref = fa.mha_reference(q, k, v, mask)
        ref_grads = fa.flash_attention_plain_backward(q, k, v, mask, g)
        errs = {}
        for name, mm in (("3x", tf32.mm_3xtf32), ("1x", tf32.mm_tf32)):
            out = three_tf32_flash(q, k, v, mask, g, mm=mm)
            errs[name] = max([float((out[0] - ref).abs().max())]
                             + [scale_err(a, b)
                                for a, b in zip(out[1:], ref_grads)])
        assert errs["1x"] >= 10 * errs["3x"], errs


class TestFlashRoute:
    """``flash_route``: the dtype and head dim alone pick the kernels,
    before any launch, and a forward and its backward take one route."""

    @pytest.mark.parametrize("head_dim", [8, 16, 24, 32, 40, 48, 56, 64])
    def test_fp32_multiples_of_8_up_to_64_run_tf32(self, head_dim):
        assert fa.flash_route(torch.float32, head_dim) == "tf32"

    @pytest.mark.parametrize("head_dim", [4, 12, 20, 63, 72, 96, 128])
    def test_other_fp32_head_dims_run_simt(self, head_dim):
        # 12: the harness's tiny preset (hidden 24, 2 heads)
        assert fa.flash_route(torch.float32, head_dim) == "simt"

    @pytest.mark.parametrize("head_dim", [12, 16, 64, 128])
    def test_bf16_runs_wgmma(self, head_dim):
        assert fa.flash_route(torch.bfloat16, head_dim) == "wgmma"

    def test_other_dtypes_have_no_route(self):
        with pytest.raises(ValueError, match="no flash attention kernel"):
            fa.flash_route(torch.float64, 16)

    def test_every_shipped_config_runs_tf32_in_fp32(self):
        from bert4rec_tpu_torch.config import (list_train_configs,
                                               load_train_config)
        names = list_train_configs()
        assert names
        for name in names:
            cfg = load_train_config(name, vocab_size=100)
            d = cfg.hidden_size // cfg.num_attention_heads
            assert fa.flash_route(torch.float32, d) == "tf32", name

    @pytest.mark.parametrize("dtype, d, rate, route", [
        (torch.float32, 16, 0.2, "tf32"), (torch.float32, 64, 0.0, "tf32"),
        (torch.float32, 12, 0.2, "simt"), (torch.bfloat16, 16, 0.2, "wgmma")])
    def test_backward_takes_the_forward_route(self, dtype, d, rate, route,
                                              monkeypatch):
        """The wrapper's forward (saving) and its backward pick the same
        route: each call is recorded, and the kernel library is stubbed to
        stop each launch before it reaches a card."""
        seen, real = [], fa.flash_route

        def spy(*args):
            seen.append(real(*args))
            return seen[-1]

        class Stop(Exception):
            pass

        def stop():
            raise Stop

        monkeypatch.setattr(fa, "flash_route", spy)
        monkeypatch.setattr(fa, "_kernel_lib", stop)
        q = torch.zeros((2, 3, 5, d), dtype=dtype)
        mask = torch.ones((2, 5), dtype=torch.int32)
        with pytest.raises(Stop):
            fa._launch_forward(q, q, q, mask, 7, rate, False, True)
        saved = (torch.zeros((2, 3, 5)), torch.ones((2, 3, 5)), q)
        with pytest.raises(Stop):
            fa._launch_backward(q, q, q, mask, q, saved, 7, rate, False)
        assert seen == [route, route]

    def test_a_misaligned_fp32_view_is_copied_for_the_tf32_kernels(
            self, monkeypatch):
        """The 3xTF32 route copies an fp32 view that breaks the 16-byte
        rule (here a base 4 bytes off) into a contiguous buffer; the main
        path's views of one projection reach the library as they are."""
        calls = []

        class Lib:
            @staticmethod
            def b4r_flash_max_head_dim():
                return 128

            @staticmethod
            def b4r_flash_fwd(dtype, ptrs, strides, *rest):
                calls.append((list(ptrs)[:5], list(strides)))
                return 0

        monkeypatch.setattr(fa, "_kernel_lib", lambda: Lib)
        monkeypatch.setattr(fa.torch.cuda, "current_stream",
                            lambda device=None: type("S", (), {
                                "cuda_stream": 0})())
        b, s, n, d = 2, 5, 3, 16
        proj = torch.zeros((b, s, 3, n, d))
        q, k, v = (proj[:, :, i].transpose(1, 2) for i in range(3))
        mask = torch.ones((b, s), dtype=torch.int32)
        fa._launch_forward(q, k, v, mask, 7, 0.0, False, False)
        assert calls[-1][0][:3] == [t.data_ptr() for t in (q, k, v)]
        bad = torch.zeros(q.numel() + 1)[1:].view(q.shape)
        assert fa._misaligned(bad)
        fa._launch_forward(q, k, bad, mask, 7, 0.0, False, False)
        ptrs, strides = calls[-1]
        assert ptrs[2] != bad.data_ptr() and ptrs[2] % 16 == 0
        assert strides[6:9] == [n * s * d, s * d, d]

    def test_the_cpu_path_counts_no_route(self):
        before = {name: getattr(fa.flash_attention, name) for name in (
            "tf32_launches", "tf32_backward_launches", "simt_launches",
            "simt_backward_launches")}
        q, k, v, mask, g = self.operands_np()
        port_run(q, k, v, mask, g)
        assert before == {name: getattr(fa.flash_attention, name)
                          for name in before}

    @staticmethod
    def operands_np():
        return TestThreeTf32Flash.operands(24)


# --------------------------------------------------------------------------- #
# the encoder, SASRec, remat and output_range
# --------------------------------------------------------------------------- #

def both_models(jax_cls, port_cls, seed, **over):
    kw = model_kwargs(**over)
    jmodel = jax_cls(config=JaxConfig(**kw))
    flat = random_params(jmodel, seed)
    return jmodel, port_cls(config=BERT4RecConfig(**kw)), flat


class TestEncoderOnFlash:

    @pytest.mark.parametrize("norm_first", [False, True],
                             ids=["post_ln", "pre_ln"])
    def test_flash_encoder_matches_jax(self, norm_first):
        jmodel, model, flat = both_models(
            JaxModel, BERT4RecModel, 11, use_flash_attention=True,
            norm_first=norm_first)
        feats = features(11)
        ref = jmodel.apply(to_jax(flat),
                           {k: jnp.asarray(v) for k, v in feats.items()})
        out = model.apply(params_from_numpy(flat, "cpu"),
                          {k: torch.from_numpy(v) for k, v in feats.items()})
        # test_ops.py's flash encoder bound
        for key in ("sequence_output", "mlm_logits"):
            np.testing.assert_allclose(out[key].detach().numpy(),
                                       np.asarray(ref[key]), rtol=2e-4,
                                       atol=2e-4, err_msg=key)

    def test_flash_and_plain_attention_agree(self):
        """The same encoder with and without flash attention: one
        function, two routes."""
        _, model, flat = both_models(JaxModel, BERT4RecModel, 12)
        flash = BERT4RecModel(config=model.config.replace(
            use_flash_attention=True))
        params = params_from_numpy(flat, "cpu")
        feats = {k: torch.from_numpy(v) for k, v in features(12).items()}
        np.testing.assert_allclose(
            flash.apply(params, feats)["mlm_logits"].numpy(),
            model.apply(params, feats)["mlm_logits"].numpy(), rtol=2e-4,
            atol=2e-4)

    def test_sasrec_on_flash_matches_jax(self):
        """SASRec's causal encoder reaches the causal flash path (JAX
        tests/models_tests/test_sasrec.py:215)."""
        jmodel, model, flat = both_models(JaxSASRec, SASRecModel, 13,
                                          use_flash_attention=True)
        feats = features(13)
        ref = jmodel.apply(to_jax(flat),
                           {k: jnp.asarray(v) for k, v in feats.items()})
        out = model.apply(params_from_numpy(flat, "cpu"),
                          {k: torch.from_numpy(v) for k, v in feats.items()})
        np.testing.assert_allclose(out["sequence_output"].numpy(),
                                   np.asarray(ref["sequence_output"]),
                                   rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
    @pytest.mark.parametrize("causal", [False, True],
                             ids=["bidirectional", "causal"])
    def test_output_range_matches_jax(self, flash, causal):
        """``output_range=1``: the last layer computes position 0 only (off
        flash attention, reading the dense bias with its triangle)."""
        jcls, pcls = (JaxSASRec, SASRecModel) if causal else \
            (JaxModel, BERT4RecModel)
        jmodel, model, flat = both_models(jcls, pcls, 14,
                                          use_flash_attention=flash)
        feats = features(14)
        del feats["masked_lm_positions"]   # positions past the range
        ref = jmodel.apply(to_jax(flat),
                           {k: jnp.asarray(v) for k, v in feats.items()},
                           output_range=1)
        tf = {k: torch.from_numpy(v) for k, v in feats.items()}
        params = params_from_numpy(flat, "cpu")
        out = model.apply(params, tf, output_range=1)
        assert out["sequence_output"].shape == (4, 1, 32)
        # JAX's law: output_range takes the fused layer off
        fused = pcls(config=model.config.replace(use_fused_layer=True))
        assert fused.encoder.fused_layer_routed(4, 24)
        assert not fused.encoder.fused_layer_routed(4, 24, output_range=1)
        for key in ("sequence_output", "pooled_output"):
            np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                       rtol=1e-4, atol=1e-4, err_msg=key)
        # the encoder's first layers are untouched by the slicing
        full = model.apply(params, tf)
        np.testing.assert_allclose(
            out["encoder_outputs"][0].numpy(),
            full["encoder_outputs"][0].numpy(), rtol=0, atol=0)

    @pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
    def test_remat_gives_the_same_outputs_and_grads(self, flash):
        """Each unfused block under torch.utils.checkpoint: values and
        gradients equal the plain run's (dropout on: the recomputation
        draws the same masks); JAX's test_remat_identical_outputs_and_grads
        at the port's own bound (bit for bit)."""
        runs = []
        for remat in (False, True):
            _, model, flat = both_models(
                JaxModel, BERT4RecModel, 15, use_flash_attention=flash,
                remat=remat, attention_dropout=0.2, output_dropout=0.3)
            params = params_from_numpy(flat, "cpu")
            for leaf in flatten(params).values():
                leaf.requires_grad_(True)
            feats = {k: torch.from_numpy(v) for k, v in features(15).items()}
            out = model.encoder.apply(params["encoder"],
                                      feats["input_word_ids"],
                                      feats["input_mask"], training=True,
                                      seed=7)["sequence_output"]
            leaves = list(flatten(params["encoder"]).values())
            grads = torch.autograd.grad(out.square().sum(), leaves,
                                        allow_unused=True)
            runs.append((out.detach(), grads))
        assert torch.equal(runs[0][0], runs[1][0])
        for a, b in zip(runs[0][1], runs[1][1]):
            assert (a is None and b is None) or torch.equal(a, b)

    def test_remat_wraps_each_unfused_block_only(self, monkeypatch):
        import torch.utils.checkpoint as ckpt
        calls = []
        real = ckpt.checkpoint
        monkeypatch.setattr(ckpt, "checkpoint",
                            lambda *a, **k: calls.append(k) or real(*a, **k))
        feats = {k: torch.from_numpy(v) for k, v in features(16).items()}
        for fused, want in ((False, 2), (True, 0)):
            calls.clear()
            _, model, flat = both_models(JaxModel, BERT4RecModel, 16,
                                         remat=True, use_fused_layer=fused)
            model.apply(params_from_numpy(flat, "cpu"), feats)
            assert len(calls) == want
            assert all(k == {"use_reentrant": False} for k in calls)


class TestReferenceDefaultEncoder:

    def test_param_structure_matches_jax_at_bert_base_512(self):
        """The path's own config, hidden 768, 12 layers, S=512: the port's
        shapes-only init has every key and shape of JAX's (an abstract
        JAX init: nothing is computed), so a JAX npz at this size carries
        across through params_from_numpy."""
        kw = dict(vocab_size=3709, hidden_size=768, num_layers=12,
                  num_attention_heads=12, inner_dim=3072,
                  max_sequence_length=512, max_predictions_per_seq=76,
                  attention_dropout=0.2, output_dropout=0.5,
                  use_fused_layer=False, use_fused_loss=False,
                  use_flash_attention=True, remat=False)
        jshapes = jax.eval_shape(JaxModel(config=JaxConfig(**kw)).init,
                                 jax.random.key(0))
        theirs = {k: tuple(v.shape) for k, v in flatten(jshapes).items()}
        model = BERT4RecModel(config=BERT4RecConfig(**kw))
        ours = model.init(device="meta")
        assert {k: tuple(v.shape) for k, v in flatten(ours).items()} \
            == theirs
        assert len(ours["encoder"]["layers"]) == 12
        assert Bert4RecEncoder(model.config).init(device="meta")[
            "layers"]["layer_11"]["attention"]["qkv"]["kernel"].shape \
            == (768, 3, 12, 64)
        # zero-stride stand-ins for the npz arrays: no memory is taken
        flat = {k: np.broadcast_to(np.float32(0), s)
                for k, s in theirs.items()}
        checkpoint.check_structure(flat, ours)
        # the encoder this config routes: flash attention, not the fused
        # layer (JAX's VMEM law turns it away)
        assert not model.encoder.fused_layer_routed(32, 512)


class TestTrainStepOnFlash:

    OVER = dict(use_fused_layer=False, use_fused_loss=False,
                use_flash_attention=True)

    def test_step_matches_the_jax_trainer(self):
        """A small bert-like config on flash attention: loss, metrics and
        every gradient of one batch, then the params after one AdamW step,
        against the JAX trainer (interpret kernel at rate 0)."""
        jt = tt.jax_trainer(**self.OVER)
        init = tt.host_params(jt)
        batch = next(tt.dataset(n=16, seed=4).batches(16, seed=0))
        jparams = jt.params
        (jloss, jlogs), jgrads = jax.value_and_grad(
            lambda p: jt.model.loss_and_metrics(
                p, {k: jnp.asarray(v) for k, v in batch.items()}),
            has_aux=True)(jparams)
        pt = tt.port_trainer(init, **self.OVER)
        tb = pt._put_batch(batch)
        loss, logs, grads = pt._grads(tb, 0)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        for k in ("masked_accuracy", "accuracy"):
            np.testing.assert_allclose(float(logs[k]), float(jlogs[k]),
                                       atol=1e-7)
        for k, g in flatten(jgrads).items():
            np.testing.assert_allclose(grads[k].numpy(), np.asarray(g),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        jt.train(tt.dataset(n=16, seed=4), epochs=1, batch_size=16,
                 steps_per_epoch=1, verbose=False)
        pt.train(tt.dataset(n=16, seed=4), epochs=1, batch_size=16,
                 steps_per_epoch=1, verbose=False)
        ours = tt.host_params(pt)
        # the trainer tests' Adam bound (test_torch_trainer.py)
        for k, v in tt.host_params(jt).items():
            np.testing.assert_allclose(ours[k], v, rtol=0, atol=2e-5,
                                       err_msg=k)
