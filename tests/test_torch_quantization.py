"""int8 weights-only tables held against the JAX package on the CPU: the
codes and per-row scales equal JAX's bit for bit (half-to-even rounding, a
zero row, rows at the clip); ``quantize_params`` / ``dequantize_params`` /
``is_quantized`` / ``table_bytes`` as JAX's; the quantized lookup, the
dequantized fallback table, the quantized ``mlm_logits`` / ``rank_top_k``
and ``score_candidates`` within 1e-5 relative of JAX's with the top-k ids
equal; the ml-1m table's bytes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models import BERT4RecModel as JaxModel
from bert4rec_tpu.models import quantization as jax_q
from bert4rec_tpu.models.components import layers as jax_layers
from bert4rec_tpu.ops import candidate_scoring as jax_cs
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
from bert4rec_tpu_torch.models import Bert4RecEncoder, quantization
from bert4rec_tpu_torch.models.components import layers
from bert4rec_tpu_torch.ops import candidate_scoring
from bert4rec_tpu_torch.utils import checkpoint

V, S, P = 97, 16, 4


def table(seed=0, v=V, w=32):
    rng = np.random.default_rng(seed)
    t = rng.normal(scale=0.05, size=(v, w)).astype(np.float32)
    t[0] = 0.0                                   # a zero row
    t[1] = np.linspace(-1, 1, w, dtype=np.float32)
    # entries at exactly half a step: round half to even
    t[2] = (np.arange(w, dtype=np.float32) - w / 2) * (0.5 / 127)
    t[2, -1] = 0.5
    return t


def to_torch(tree):
    return checkpoint.params_from_numpy(
        {k: np.asarray(v) for k, v in checkpoint.flatten(
            jax.tree_util.tree_map(np.asarray, tree)).items()}, "cpu")


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


class TestCodes:

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_codes_and_scales_equal_jax_bit_for_bit(self, seed):
        t = table(seed)
        ours = layers.quantize_embedding({"embedding": torch.from_numpy(t)})
        theirs = jax_layers.quantize_embedding({"embedding": jnp.asarray(t)})
        assert ours["embedding_q"].dtype == torch.int8
        np.testing.assert_array_equal(ours["embedding_q"].numpy(),
                                      np.asarray(theirs["embedding_q"]))
        np.testing.assert_array_equal(
            ours["embedding_scale"].numpy().view(np.uint32),
            np.asarray(theirs["embedding_scale"]).view(np.uint32))
        np.testing.assert_array_equal(
            layers.dequantize_embedding(ours).numpy(),
            np.asarray(jax_layers.dequantize_embedding(theirs)))
        ids = np.random.default_rng(seed).integers(0, V, (3, 5))
        np.testing.assert_array_equal(
            layers.embedding_lookup(ours, torch.from_numpy(ids)).numpy(),
            np.asarray(jax_layers.embedding_lookup(theirs,
                                                   jnp.asarray(ids))))

    def test_params_helpers_follow_jax(self):
        jmodel = JaxModel(config=JaxConfig(
            vocab_size=V, hidden_size=32, num_layers=1,
            num_attention_heads=2, inner_dim=64, max_sequence_length=S))
        jparams = jmodel.init(jax.random.key(0))
        params = to_torch(jparams)
        q, jq = quantization.quantize_params(params), \
            jax_q.quantize_params(jparams)
        assert quantization.is_quantized(q) and not \
            quantization.is_quantized(params)
        assert quantization.quantize_params(q) is q
        assert quantization.table_bytes(q) == jax_q.table_bytes(jq) \
            == V * 32 + V * 4
        assert quantization.table_bytes(params) == \
            jax_q.table_bytes(jparams) == V * 32 * 4
        assert q["mlm"] is params["mlm"]          # shared, not copied
        back = quantization.dequantize_params(q)
        np.testing.assert_array_equal(
            back["encoder"]["item_embeddings"]["embedding"].numpy(),
            np.asarray(jax_q.dequantize_params(jq)["encoder"]
                       ["item_embeddings"]["embedding"]))
        np.testing.assert_array_equal(
            Bert4RecEncoder.get_embedding_table(q["encoder"]).numpy(),
            back["encoder"]["item_embeddings"]["embedding"].numpy())

    def test_ml1m_table_bytes(self):
        """The ml-1m_128 table (3,709 x 128): 1,899,008 bytes in fp32,
        489,588 as int8 codes + fp32 scales (JAX's
        quality_runs/oracle_ml1m_fr_int8)."""
        params = {"encoder": {"item_embeddings": {
            "embedding": torch.zeros((3709, 128))}}}
        assert quantization.table_bytes(params) == 1_899_008
        assert quantization.table_bytes(
            quantization.quantize_params(params)) == 489_588


@pytest.fixture(scope="module", params=[
    dict(use_fused_layer=True), dict(use_fused_layer=False, vocab_pad_to=8)],
    ids=["fused", "unfused_padded"])
def quantized(request):
    """The same fp32 params quantized in each package (a random output
    bias, so the logits are tie-free), the models and a batch."""
    kw = dict(vocab_size=V, hidden_size=32, num_layers=2,
              num_attention_heads=4, inner_dim=64, max_sequence_length=S,
              max_predictions_per_seq=P, **request.param)
    jmodel = JaxModel(config=JaxConfig(**kw))
    model = BERT4RecModel(config=BERT4RecConfig(**kw))
    jparams = jmodel.init(jax.random.key(1))
    rng = np.random.default_rng(1)
    jparams["mlm"]["output_bias"] = jnp.asarray(rng.normal(
        size=jparams["mlm"]["output_bias"].shape).astype(np.float32))
    params = quantization.quantize_params(to_torch(jparams))
    jq = jax_q.quantize_params(jparams)
    b = 3
    feats = dict(
        input_word_ids=rng.integers(3, V, (b, S)).astype(np.int32),
        input_mask=np.ones((b, S), np.int32),
        masked_lm_positions=rng.integers(0, S, (b, P)).astype(np.int32))
    feats["input_mask"][0, 10:] = 0
    return model, params, jmodel, jq, feats


class TestQuantizedPaths:

    def test_logits_and_top_k_follow_jax(self, quantized):
        model, params, jmodel, jq, feats = quantized
        ours = model.apply(params, {k: torch.from_numpy(v)
                                    for k, v in feats.items()})
        theirs = jmodel.apply(jq, {k: jnp.asarray(v)
                                   for k, v in feats.items()})
        assert rel_err(ours["mlm_logits"].numpy(),
                       theirs["mlm_logits"]) <= 1e-5
        exclude = np.array([[3, 4, -1], [5, -1, -1], [7, 8, 9]], np.int32)
        ids, vals = model.rank_top_k(
            params, {k: torch.from_numpy(v) for k, v in feats.items()}, 10,
            exclude=torch.from_numpy(exclude))
        jids, jvals = jmodel.rank_top_k(
            jq, {k: jnp.asarray(v) for k, v in feats.items()}, 10,
            exclude=jnp.asarray(exclude))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        assert rel_err(vals.numpy(), jvals) <= 1e-5

    def test_score_candidates_follow_jax(self, quantized):
        model, params, jmodel, jq, feats = quantized
        cands = np.random.default_rng(2).integers(0, V, (3, P, 11)) \
            .astype(np.int32)
        ours = model.score_candidates(
            params, {k: torch.from_numpy(v) for k, v in feats.items()},
            torch.from_numpy(cands))
        theirs = jmodel.score_candidates(
            jq, {k: jnp.asarray(v) for k, v in feats.items()},
            jnp.asarray(cands))
        assert ours.shape == (3, P, 11)
        assert rel_err(ours.numpy(), theirs) <= 1e-5

    def test_quantized_candidate_scoring_is_the_dequantized_math(self):
        """``(h . q) * s + b`` equals scoring the dequantized table, up to
        fp32 rounding, as JAX's op does."""
        rng = np.random.default_rng(4)
        emb = layers.quantize_embedding(
            {"embedding": torch.from_numpy(table(4))})
        h = torch.from_numpy(rng.normal(size=(2, 3, 32)).astype(np.float32))
        bias = torch.from_numpy(rng.normal(size=V).astype(np.float32))
        cands = torch.from_numpy(rng.integers(0, V, (2, 3, 7)))
        got = candidate_scoring.score_candidates_quantized(h, emb, bias,
                                                           cands)
        want = candidate_scoring.score_candidates(
            h, layers.dequantize_embedding(emb), bias, cands)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
        theirs = jax_cs.score_candidates_quantized(
            jnp.asarray(h.numpy()),
            {k: jnp.asarray(v.numpy()) for k, v in emb.items()},
            jnp.asarray(bias.numpy()), jnp.asarray(cands.numpy()))
        assert rel_err(got.numpy(), theirs) <= 1e-5
