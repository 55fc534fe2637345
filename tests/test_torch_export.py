"""Serving export on the CPU: ``models/export.py`` traces the port's models
with ``torch.export`` at a symbolic batch; one artifact serves B = 1, 3 and
8 with the eager model's outputs (top-k with and without exclusion,
candidate scores; fp32 and int8), through ``save_artifact`` /
``load_artifact``; the kernels are registered operators that the program
calls (``torch.library.opcheck`` holds each); the batch laws bound the
symbolic batch instead of pinning it; ``ArtifactRecommender`` and the
serving stack over it return the eager ``Recommender``'s ids."""

import importlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from bert4rec_tpu_torch.apps import (
    ArtifactRecommender, Recommender, RecommenderService,
)
from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel, export
from bert4rec_tpu_torch.models import quantization
from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
from bert4rec_tpu_torch.ops import sharded_topk
from tests import test_utils

# the module (the package's ``flash_attention`` is the function)
fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
V, S, P, K, E = 61, 16, 4, 5, 12
OPS = {"fused": "bert4rec_tpu_torch.fused_layer_forward",
       "flash": "bert4rec_tpu_torch.flash_attention_forward"}


def config(kind="fused", **over):
    kw = dict(vocab_size=V, hidden_size=32, num_layers=2,
              num_attention_heads=4, inner_dim=64, max_sequence_length=S,
              max_predictions_per_seq=P, use_fused_layer=kind == "fused",
              use_flash_attention=kind == "flash")
    kw.update(over)
    return BERT4RecConfig(**kw)


def model_and_params(kind="fused", seed=0):
    model = BERT4RecModel(config=config(kind))
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    # a random output bias: tie-free logits
    params["mlm"]["output_bias"] = torch.from_numpy(
        np.random.default_rng(seed).normal(size=V).astype(np.float32))
    return model, params


def inputs(b, seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, S), np.int32)
    mask[0, S // 2:] = 0
    return [torch.from_numpy(a) for a in (
        rng.integers(3, V, (b, S)).astype(np.int32), mask,
        rng.integers(0, S // 2, (b, P)).astype(np.int32),
        rng.integers(-1, V + 2, (b, E)).astype(np.int32))]


def graph_ops(exported) -> list:
    return [str(n.target) for n in exported.graph.nodes
            if n.op == "call_function"
            and str(n.target).startswith("bert4rec_tpu_torch.")]


@pytest.fixture(scope="module", params=["fused", "flash"])
def served(request, tmp_path_factory):
    """A model of each kernel family, its params, and its top-k artifact
    (with exclusion), saved and loaded back."""
    model, params = model_and_params(request.param)
    path = tmp_path_factory.mktemp("art") / "top_k.pt2"
    export.save_artifact(export.export_top_k(model, params, K,
                                             num_exclude=E), path)
    return request.param, model, params, export.load_artifact(path)


class TestExportedPrograms:

    @pytest.mark.parametrize("b", [1, 3, 8])
    def test_one_artifact_serves_every_batch(self, served, b):
        kind, model, params, art = served
        ids, mask, pos, exclude = inputs(b, b)
        feats = dict(input_word_ids=ids, input_mask=mask,
                     masked_lm_positions=pos)
        got = art.module()(ids, mask, pos, exclude)
        with torch.no_grad():
            want = model.rank_top_k(params, feats, K, exclude=exclude)
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
        assert got[0].shape == (b, P, K)

    def test_program_calls_the_kernel_operator_per_layer(self, served):
        kind, model, _, art = served
        assert graph_ops(art).count(f"{OPS[kind]}.default") == \
            model.config.num_layers
        b = export.input_shapes(art)[0][0]
        assert isinstance(b, torch.SymInt)
        assert [s[1:] for s in export.input_shapes(art)] == \
            [(S,), (S,), (P,), (E,)]
        assert [s[1:] for s in export.output_shapes(art)] == [(P, K)] * 2

    @pytest.mark.parametrize("quantize", [None, "int8"])
    @pytest.mark.parametrize("with_exclude", [False, True])
    def test_top_k_equals_eager(self, quantize, with_exclude):
        model, params = model_and_params("fused", seed=1)
        art = export.export_top_k(model, params, K, quantize=quantize,
                                  num_exclude=E if with_exclude else None)
        served_params = (quantization.quantize_params(params)
                         if quantize else params)
        for b in (1, 3, 8):
            ids, mask, pos, exclude = inputs(b, 10 + b)
            args = [ids, mask, pos] + ([exclude] if with_exclude else [])
            got = art.module()(*args)
            with torch.no_grad():
                want = model.rank_top_k(
                    served_params, dict(input_word_ids=ids, input_mask=mask,
                                        masked_lm_positions=pos), K,
                    exclude=exclude if with_exclude else None)
            assert torch.equal(got[0], want[0])
            torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)

    @pytest.mark.parametrize("quantize", [None, "int8"])
    def test_score_candidates_equals_eager(self, quantize, tmp_path):
        model, params = model_and_params("fused", seed=2)
        art = export.export_score_candidates(model, params, 7,
                                             quantize=quantize)
        export.save_artifact(art, tmp_path / "s.pt2")
        art = export.load_artifact(tmp_path / "s.pt2")
        served_params = (quantization.quantize_params(params)
                         if quantize else params)
        for b in (1, 3, 8):
            ids, mask, pos, _ = inputs(b, 20 + b)
            cands = torch.from_numpy(np.random.default_rng(b).integers(
                0, V, (b, P, 7)).astype(np.int32))
            got = art.module()(ids, mask, pos, cands)
            with torch.no_grad():
                want = model.score_candidates(
                    served_params, dict(input_word_ids=ids, input_mask=mask,
                                        masked_lm_positions=pos), cands)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)

    def test_int8_artifact_holds_the_int8_table(self):
        model, params = model_and_params("fused", seed=3)
        for q, want in ((None, {"embedding": torch.float32}),
                        ("int8", {"embedding_q": torch.int8,
                                  "embedding_scale": torch.float32})):
            art = export.export_top_k(model, params, K, quantize=q)
            table = {k.rsplit("__", 1)[-1]: v
                     for k, v in art.state_dict.items()
                     if "item_embeddings" in k}
            assert {k: v.dtype for k, v in table.items()} == want
            assert sum(v.numel() * v.element_size()
                       for v in table.values()) == \
                (V * 32 * 4 if q is None else V * 32 + V * 4)
        with pytest.raises(ValueError, match="quantize"):
            export.export_top_k(model, params, K, quantize="int4")

    def test_concrete_batch_pins_the_shape(self):
        model, params = model_and_params("fused", seed=4)
        art = export.export_top_k(model, params, K, batch_size=3)
        assert export.input_shapes(art)[0] == (3, S)


class TestBatchLaw:

    def test_limit_is_the_vmem_law_where_the_layer_fuses(self):
        """At ml-1m_128's shape JAX's VMEM law (it counts the batch's
        mask) fuses the layer up to 12,200 rows: that is the symbolic
        batch's max, and one row more would pin the program (export
        refuses: the guard does not hold over the range)."""
        model = BERT4RecModel(config=config(
            hidden_size=128, inner_dim=512, max_sequence_length=200,
            max_predictions_per_seq=40))
        limit = export.batch_limit(model)
        assert fel.fused_layer_supported(
            batch=limit, seq_len=200, hidden=128, inner_dim=512,
            num_heads=4, dtype_bytes=4)
        assert not fel.fused_layer_supported(
            batch=limit + 1, seq_len=200, hidden=128, inner_dim=512,
            num_heads=4, dtype_bytes=4)
        assert limit == 12_200
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        art = export.export_top_k(model, params, 10)
        assert graph_ops(art).count(f"{OPS['fused']}.default") == 2
        from unittest import mock
        with mock.patch.object(export, "batch_limit",
                               lambda m: limit + 1), \
                pytest.raises(Exception, match="Constraints violated"):
            export.export_top_k(model, params, 10)

    def test_unfused_models_take_the_kernels_batch_limit(self):
        assert export.batch_limit(BERT4RecModel(config=config("flash"))) \
            == export.batch_limit(BERT4RecModel(config=config())) \
            == fel.MAX_KERNEL_BATCH

    def test_eager_routes_are_unchanged(self):
        """Eager inference calls the registered operator (one code path
        with the exported program); training still runs the autograd
        Function that saves for K2."""
        model, params = model_and_params("fused", seed=5)
        ids, mask, pos, _ = inputs(2, 0)
        calls = []
        real = fel._FusedLayer.apply

        def spy(*args):
            calls.append("function")
            return real(*args)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fel._FusedLayer, "apply", spy)
            with torch.no_grad():
                model.apply(params, dict(input_word_ids=ids, input_mask=mask,
                                         masked_lm_positions=pos))
            assert calls == []
            grads = {k: v.requires_grad_(True) for k, v in
                     params["encoder"]["layers"]["layer_0"]
                     ["attention"]["qkv"].items()}
            model.apply(params, dict(input_word_ids=ids, input_mask=mask,
                                     masked_lm_positions=pos))
            assert calls == ["function"] * 2
            for v in grads.values():
                v.requires_grad_(False)

    def test_exclusion_bias_is_the_masked_scatter(self):
        rng = np.random.default_rng(0)
        exclude = torch.from_numpy(rng.integers(-3, V + 3, (5, 9)))
        got = sharded_topk.exclusion_bias(exclude, V)
        want = torch.zeros((5, V))
        for r, row in enumerate(exclude.tolist()):
            for t in row:
                if 0 <= t < V:
                    want[r, t] = -1e9
        assert torch.equal(got, want)


class TestRegisteredOperators:

    @pytest.mark.parametrize("variant", ["plain", "causal", "rel", "bf16"])
    def test_fused_layer_operator_passes_opcheck(self, variant):
        rng = np.random.default_rng(1)
        h, n, f, b, s = 32, 4, 64, 2, 8
        dtype = torch.bfloat16 if variant == "bf16" else torch.float32
        layer = BERT4RecModel(config=config()).init(
            torch.Generator().manual_seed(1), device="cpu")[
            "encoder"]["layers"]["layer_0"]
        flat = fel.flat_weights(layer)
        x = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)) \
            .to(dtype)
        mask = torch.ones((b, s), dtype=torch.int32)
        mask[1, 5:] = 0
        rel = (torch.from_numpy(rng.normal(size=(b, n, s, s))
                                .astype(np.float32))
               if variant == "rel" else None)
        args = (x, mask, [flat[k].contiguous() for k in fel._W_ORDER], rel,
                n, variant == "causal", 0, 0.0, 0.0)
        torch.library.opcheck(fel.fused_layer_forward, args)
        want = fel.fused_encoder_layer_plain(
            layer, x, mask, num_heads=n, causal=variant == "causal",
            rel_bias=rel)
        assert torch.equal(fel.fused_layer_forward(*args), want)

    @pytest.mark.parametrize("layout", ["contiguous", "projection"])
    def test_flash_operator_passes_opcheck(self, layout):
        rng = np.random.default_rng(2)
        b, n, s, d = 2, 3, 10, 8
        if layout == "projection":   # views of one [B, S, 3, N, D] tensor
            qkv = torch.from_numpy(rng.normal(size=(b, s, 3, n, d))
                                   .astype(np.float32))
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q, k, v = (torch.from_numpy(rng.normal(size=(b, n, s, d))
                                        .astype(np.float32))
                       for _ in range(3))
        mask = torch.ones((b, s), dtype=torch.int32)
        mask[0, 7:] = 0
        args = (q, k, v, mask, 0, 0.0, False)
        torch.library.opcheck(fa.flash_attention_forward, args)
        out = fa.flash_attention_forward(*args)
        assert out.stride() == fa._empty_heads(q).stride()
        torch.testing.assert_close(out, fa.mha_reference(q, k, v, mask),
                                   rtol=0, atol=0)

    def test_artifact_needs_the_ports_operators(self, served, tmp_path):
        """A ``.pt2`` holding the port's operators loads where
        ``bert4rec_tpu_torch.ops`` is imported, and not without it (a
        departure from JAX's artifact, which needs only jax)."""
        kind, _, _, art = served
        path = tmp_path / "a.pt2"
        export.save_artifact(art, path)
        code = textwrap.dedent(f"""
            import sys, torch
            try:
                torch.export.load({str(path)!r})
                print("loaded without the port")
            except Exception as e:
                print("refused", type(e).__name__)
            import bert4rec_tpu_torch.ops
            p = torch.export.load({str(path)!r})
            b = 2
            args = [torch.zeros((b, {S}), dtype=torch.int32) + 3,
                    torch.ones((b, {S}), dtype=torch.int32),
                    torch.zeros((b, {P}), dtype=torch.int32),
                    torch.full((b, {E}), -1, dtype=torch.int32)]
            print(tuple(p.module()(*args)[0].shape))
            print(sorted(m for m in sys.modules
                         if m.split(".")[0] == "bert4rec_tpu_torch"
                         and m.startswith("bert4rec_tpu_torch.models")))
        """)
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        lines = out.stdout.splitlines()
        assert lines[0].startswith("refused"), lines
        assert lines[1] == f"(2, {P}, {K})"
        assert lines[2] == "[]"      # no model code was imported


@pytest.fixture(scope="module")
def apps_setup():
    dl = BERT4RecDataloader(S, P)
    vocab = test_utils.generate_random_word_list(n_words=V - 3, seed=0)
    dl.generate_vocab(vocab)
    model, params = model_and_params("fused", seed=6)
    art = export.export_top_k(model, params, K, num_exclude=E)
    return dl, vocab, model, params, art


class TestArtifactRecommender:

    def test_reads_its_shape_off_the_program(self, apps_setup):
        dl, _, _, _, art = apps_setup
        rec = ArtifactRecommender(art, dl)
        assert (rec.exported_k, rec.exclusion_width,
                rec.max_history_items) == (K, E, E - 3)
        assert rec.device == torch.device("cpu")

    def test_refuses_an_artifact_without_exclusion(self, apps_setup):
        dl, _, model, params, _ = apps_setup
        with pytest.raises(ValueError, match="num_exclude"):
            ArtifactRecommender(export.export_top_k(model, params, K), dl)

    def test_returns_the_eager_recommenders_ids(self, apps_setup):
        dl, vocab, model, params, art = apps_setup
        rng = np.random.default_rng(7)
        histories = [list(rng.choice(vocab, size=int(n), replace=False))
                     for n in rng.integers(1, E - 3, size=8)]
        rec = ArtifactRecommender(art, dl)
        eager = Recommender(model, params, dl, device="cpu")
        for batch in (histories[:1], histories[:3], histories):
            assert rec.recommend_batch(batch) == \
                eager.recommend_batch(batch, top_k=K)
            assert rec.recommend_batch(batch, top_k=2) == \
                eager.recommend_batch(batch, top_k=2)
        with pytest.raises(ValueError, match="exported k"):
            rec.recommend_batch(histories[:1], top_k=K + 1)

    def test_serves_through_the_service(self, apps_setup):
        dl, vocab, model, params, art = apps_setup
        rec = ArtifactRecommender(art, dl)
        eager = Recommender(model, params, dl, device="cpu")
        service = RecommenderService(rec, max_k=K, batch_capacity=4)
        try:
            history = vocab[:4]
            assert service.recommend(history, k=3) == \
                eager.recommend_batch([history], top_k=3)[0]
            with pytest.raises(ValueError, match="exclusion capacity"):
                service.submit(vocab[:E], k=1)
        finally:
            service.close()
        with pytest.raises(ValueError, match="exported k"):
            RecommenderService(rec, max_k=K + 1)


@pytest.fixture(scope="module", params=[None, "int8"], ids=["fp32", "int8"])
def jax_exported(request):
    """The same seeded params (JAX-initialised, a random output bias so the
    logits are tie-free) exported with exclusion by each package, and a
    dataloader of each over one vocabulary."""
    import jax
    from bert4rec_tpu.dataloaders import BERT4RecDataloader as JaxDataloader
    from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
    from bert4rec_tpu.models import BERT4RecModel as JaxModel
    from bert4rec_tpu.models import export as jax_export
    from bert4rec_tpu_torch.utils import checkpoint

    vocab = test_utils.generate_random_word_list(n_words=V - 3, seed=0)
    jdl = JaxDataloader(max_seq_len=S, max_predictions_per_seq=P)
    jdl.generate_vocab(vocab)
    dl = BERT4RecDataloader(S, P)
    dl.generate_vocab(vocab)
    # JAX's fused layer pins a symbolic batch (its VMEM law branches on
    # it), so JAX exports its unfused layer, the same math; the port's
    # artifact holds its fused-layer operator
    kw = config("fused").to_dict()
    jmodel = JaxModel(config=JaxConfig(**{k: kw[k] for k in (
        "vocab_size", "hidden_size", "num_layers", "num_attention_heads",
        "inner_dim", "max_sequence_length", "max_predictions_per_seq")}))
    jparams = jmodel.init(jax.random.key(8))
    jparams["mlm"]["output_bias"] = np.random.default_rng(8).normal(
        size=V).astype(np.float32)
    params = checkpoint.params_from_numpy(
        {k: np.asarray(v) for k, v in checkpoint.flatten(
            jax.tree_util.tree_map(np.asarray, jparams)).items()}, "cpu")
    model = BERT4RecModel(config=config("fused"))
    q = request.param
    jart = jax_export.export_top_k(jmodel, jparams, K, num_exclude=E,
                                   quantize=q)
    art = export.export_top_k(model, params, K, num_exclude=E, quantize=q)
    return jart, art, jdl, dl, vocab


class TestAgainstJax:

    @pytest.mark.parametrize("b", [1, 3, 8])
    def test_top_k_artifact_equals_jaxs(self, jax_exported, b):
        """The port's artifact ranks as JAX's ``export_top_k`` artifact
        does on the same params: equal ids, scores within 1e-5 relative,
        fp32 and int8."""
        jart, art, _, _, _ = jax_exported
        assert graph_ops(art).count(f"{OPS['fused']}.default") == 2
        args = inputs(b, 30 + b)
        jids, jvals = jart.call(*(a.numpy() for a in args))
        ids, vals = art.module()(*args)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        jvals = np.asarray(jvals, np.float64)
        assert np.abs(vals.numpy() - jvals).max() <= \
            1e-5 * np.abs(jvals).max()

    def test_artifact_recommenders_agree(self, jax_exported):
        from bert4rec_tpu.apps import ArtifactRecommender as JaxArtifactRec
        jart, art, jdl, dl, vocab = jax_exported
        rng = np.random.default_rng(9)
        histories = [list(rng.choice(vocab, size=int(n), replace=False))
                     for n in rng.integers(1, E - 3, size=6)]
        ours, theirs = ArtifactRecommender(art, dl), JaxArtifactRec(jart,
                                                                    jdl)
        assert (ours.exported_k, ours.exclusion_width,
                ours.max_history_items) == (theirs.exported_k,
                                            theirs.exclusion_width,
                                            theirs.max_history_items)
        for batch in (histories[:1], histories):
            assert ours.recommend_batch(batch) == \
                theirs.recommend_batch(batch)
