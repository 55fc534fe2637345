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
from bert4rec_tpu_torch.ops import dropout_bits
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
