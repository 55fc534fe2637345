"""The port's layers, unfused block, encoder, MLM head and top-k ranking
held against the JAX package on the same params and inputs (fp32, CPU)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4rec_tpu.config import CONFIG_DIR as JAX_CONFIG_DIR
from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models import BERT4RecModel as JaxModel
from bert4rec_tpu.models.components import layers as JL
from bert4rec_tpu.models.components.transformer import (
    transformer_block as jax_transformer_block,
)
from bert4rec_tpu_torch.config import CONFIG_DIR, list_train_configs
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
from bert4rec_tpu_torch.models.components import layers as L
from bert4rec_tpu_torch.models.components.transformer import (
    transformer_block,
)
from bert4rec_tpu_torch.utils.checkpoint import (
    flatten, params_from_numpy, unflatten,
)
from tests.test_torch_cuda_kernels import inputs_np, layer_params_np

B, S, H, N, F, V = 4, 24, 32, 4, 64, 61
TOL = dict(rtol=1e-4, atol=1e-4)


def model_kwargs(**over):
    kw = dict(vocab_size=V, hidden_size=H, num_layers=2,
              num_attention_heads=N, inner_dim=F, max_sequence_length=S,
              max_predictions_per_seq=3)
    kw.update(over)
    return kw


def random_params(jax_model, seed):
    """JAX-initialised params with every leaf re-drawn (biases and LN
    params included) as path-keyed numpy arrays."""
    rng = np.random.default_rng(seed)
    shapes = flatten(jax_model.init(jax.random.key(seed)))
    flat = {}
    for k, v in shapes.items():
        noise = rng.normal(size=v.shape).astype(np.float32)
        flat[k] = (1.0 + 0.1 * noise if k.endswith("/scale")
                   else 0.5 * noise if k == "mlm/output_bias"
                   else 0.1 * noise)
    return flat


def to_jax(flat):
    return unflatten({k: jnp.asarray(v) for k, v in flat.items()})


def features(seed, b=B, s=S, p=3):
    rng = np.random.default_rng(seed + 100)
    ids = rng.integers(3, V, size=(b, s)).astype(np.int32)
    lengths = rng.integers(p, s + 1, size=b)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    positions = np.stack([np.sort(rng.choice(int(n), size=p, replace=False))
                          for n in lengths]).astype(np.int32)
    return {"input_word_ids": ids * mask, "input_mask": mask,
            "masked_lm_positions": positions}


class TestConfig:

    def test_ships_the_same_json_configs(self):
        names = sorted(p.stem for p in JAX_CONFIG_DIR.glob("*.json"))
        assert list_train_configs() == names and len(names) == 13
        for name in names:
            assert json.loads((CONFIG_DIR / f"{name}.json").read_text()) \
                == json.loads((JAX_CONFIG_DIR / f"{name}.json").read_text())

    @pytest.mark.parametrize("d", [
        dict(vocab_size=10, hidden_size=64, num_attention_heads=4),
        dict(vocab_size=10, num_hidden_layers=3, intermediate_size=99,
             hidden_activation="relu", dropout_rate=0.3,
             attention_dropout_rate=0.2, max_position_embeddings=77,
             hidden_size=16, num_attention_heads=2, vocab_pad_to=8),
    ])
    def test_from_dict_matches_jax(self, d):
        ours, theirs = BERT4RecConfig.from_dict(d), JaxConfig.from_dict(d)
        assert ours.to_dict() == theirs.to_dict()
        assert (ours.padded_vocab_size, ours.head_dim, ours.table_width) \
            == (theirs.padded_vocab_size, theirs.head_dim,
                theirs.table_width)

    def test_rejects_unknown_keys_and_bad_heads(self):
        with pytest.raises(ValueError):
            BERT4RecConfig.from_dict({"vocab_size": 5, "nope": 1})
        with pytest.raises(ValueError):
            BERT4RecConfig(vocab_size=5, hidden_size=30,
                           num_attention_heads=4)


class TestLayers:

    @pytest.mark.parametrize("name", ["gelu", "gelu_approx", "relu",
                                      "tanh", "linear"])
    def test_activation_table_matches_jax(self, name):
        x = np.linspace(-5, 5, 101).astype(np.float32)
        np.testing.assert_allclose(
            L.get_activation(name)(torch.from_numpy(x)).numpy(),
            np.asarray(JL.get_activation(name)(jnp.asarray(x))),
            rtol=1e-6, atol=1e-6)

    def test_layer_norm_dense_and_mask_match_jax(self):
        rng = np.random.default_rng(0)
        x = rng.normal(size=(3, 5, H)).astype(np.float32) * 3 + 1
        ln = {"scale": rng.normal(size=H).astype(np.float32),
              "bias": rng.normal(size=H).astype(np.float32)}
        dense = {"kernel": rng.normal(size=(H, 7)).astype(np.float32),
                 "bias": rng.normal(size=7).astype(np.float32)}
        t = {k: torch.from_numpy(v) for k, v in ln.items()}
        np.testing.assert_allclose(
            L.layer_norm(t, torch.from_numpy(x)).numpy(),
            np.asarray(JL.layer_norm(ln, jnp.asarray(x))), **TOL)
        td = {k: torch.from_numpy(v) for k, v in dense.items()}
        np.testing.assert_allclose(
            L.dense(td, torch.from_numpy(x)).numpy(),
            np.asarray(JL.dense(dense, jnp.asarray(x))), **TOL)
        mask = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
        np.testing.assert_array_equal(
            L.self_attention_mask(torch.from_numpy(mask)).numpy(),
            np.asarray(JL.self_attention_mask(jnp.asarray(mask))))

    def test_truncated_normal_init_is_seeded_and_bounded(self):
        a = L.truncated_normal_init(torch.Generator().manual_seed(3),
                                    (4000,), 0.02)
        b = L.truncated_normal_init(torch.Generator().manual_seed(3),
                                    (4000,), 0.02)
        assert torch.equal(a, b)
        assert float(a.abs().max()) <= 0.04 + 1e-7
        assert 0.015 < float(a.std()) < 0.02  # truncation, no correction


class TestUnfusedBlock:

    @pytest.mark.parametrize("norm_first", [False, True])
    def test_matches_jax_transformer_block_erf_gelu(self, norm_first):
        rng = np.random.default_rng(5)
        flat = flatten(layer_params_np(rng, H, N, F))
        x, mask = inputs_np(rng, B, S, H)
        ref = jax_transformer_block(
            to_jax(flat), jnp.asarray(x),
            JL.self_attention_mask(jnp.asarray(mask)), num_heads=N,
            inner_activation=JL.get_activation("gelu"),
            output_dropout=0.0, attention_dropout=0.0, training=False,
            norm_first=norm_first)
        out = transformer_block(
            params_from_numpy(flat, "cpu"), torch.from_numpy(x),
            L.self_attention_mask(torch.from_numpy(mask)),
            inner_activation=L.get_activation("gelu"),
            norm_first=norm_first)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


class TestModelParity:

    @pytest.mark.parametrize("fused", [True, False],
                             ids=["fused", "unfused"])
    def test_encoder_and_mlm_logits_match_jax(self, fused):
        kw = model_kwargs(use_fused_layer=fused, vocab_pad_to=8)
        jax_model = JaxModel(config=JaxConfig(**kw))
        model = BERT4RecModel(config=BERT4RecConfig(**kw))
        assert model.encoder.fused_layer_routed(B, S) == fused
        flat = random_params(jax_model, 1)
        feats = features(1)
        ref = jax_model.apply(to_jax(flat),
                              {k: jnp.asarray(v) for k, v in feats.items()})
        out = model.apply(params_from_numpy(flat, "cpu"),
                          {k: torch.from_numpy(v) for k, v in feats.items()})
        for key in ("sequence_output", "pooled_output", "mlm_logits"):
            np.testing.assert_allclose(out[key].numpy(),
                                       np.asarray(ref[key]), err_msg=key,
                                       **TOL)
        # vocab-padding columns never win
        assert (out["mlm_logits"][..., V:] == -1e9).all()

    def test_fused_and_unfused_differ_by_the_gelu_only(self):
        """The fused path computes tanh gelu, the unfused erf gelu, as in
        the JAX package: the outputs differ, but only slightly."""
        outs = []
        for fused in (True, False):
            model = BERT4RecModel(config=BERT4RecConfig(
                **model_kwargs(use_fused_layer=fused)))
            flat = random_params(JaxModel(config=JaxConfig(
                **model_kwargs())), 2)
            feats = {k: torch.from_numpy(v)
                     for k, v in features(2).items()}
            outs.append(model.encoder.apply(
                params_from_numpy(flat, "cpu")["encoder"],
                feats["input_word_ids"],
                feats["input_mask"])["sequence_output"])
        diff = float((outs[0] - outs[1]).abs().max())
        assert 0 < diff < 5e-2

    def test_routing_follows_the_jax_law(self):
        def routed(**over):
            m = BERT4RecModel(config=BERT4RecConfig(**model_kwargs(**over)))
            return m.encoder.fused_layer_routed(B, S)
        assert routed(use_fused_layer=True)
        assert not routed(use_fused_layer=False)
        assert not routed(use_fused_layer=True, norm_first=True)
        assert not routed(use_fused_layer=True,
                          inner_activation="gelu_approx")
        assert not routed(use_fused_layer=True, hidden_size=768,
                          num_attention_heads=12, inner_dim=3072)

    def test_unported_paths_raise(self):
        """Every encoder path of the config now runs: flash attention gives
        the plain attention's outputs, the temporal flags build their
        tables and run with or without timestamps (a zero bias table is a
        no-op), and causal attention moves the outputs."""
        feats = {k: torch.from_numpy(v) for k, v in features(0).items()}
        base_model = BERT4RecModel(config=BERT4RecConfig(**model_kwargs()))
        params = base_model.init(torch.Generator().manual_seed(0), "cpu")
        base = base_model.apply(params, feats)["mlm_logits"]
        flash = BERT4RecModel(config=BERT4RecConfig(
            **model_kwargs(use_flash_attention=True))).apply(params, feats)
        np.testing.assert_allclose(flash["mlm_logits"].numpy(),
                                   base.numpy(), rtol=2e-4, atol=2e-4)
        stamps = torch.from_numpy(1_600_000_000 + np.cumsum(
            np.random.default_rng(1).integers(60, 90_000, size=(B, S)),
            axis=1))
        for flag, table in (("use_temporal_embeddings", "temporal_embeddings"),
                            ("use_temporal_attention",
                             "temporal_attention_bias")):
            model = BERT4RecModel(config=BERT4RecConfig(
                **model_kwargs(**{flag: True})))
            tparams = model.init(torch.Generator().manual_seed(0), "cpu")
            assert table in tparams["encoder"]
            for ts in (None, stamps):
                out = model.apply(tparams, dict(feats, input_timestamps=ts)
                                  if ts is not None else feats)["mlm_logits"]
                assert out.shape == base.shape
                assert torch.isfinite(out).all()
        temporal = dict(params, encoder=dict(
            params["encoder"], temporal_attention_bias={
                "embedding": torch.zeros((64, N))}))
        out = BERT4RecModel(config=BERT4RecConfig(**model_kwargs(
            use_temporal_attention=True))).apply(
            temporal, dict(feats, input_timestamps=stamps))["mlm_logits"]
        np.testing.assert_allclose(out.numpy(), base.numpy(), rtol=1e-5,
                                   atol=1e-5)
        causal = BERT4RecModel(config=BERT4RecConfig(
            **model_kwargs(causal_attention=True)))
        out = causal.apply(params, feats)["mlm_logits"]
        assert torch.isfinite(out).all()
        assert float((out - base).abs().max()) > 1e-3

    def test_init_structure_matches_jax(self):
        kw = model_kwargs(embedding_width=16)
        jax_shapes = {k: tuple(v.shape) for k, v in flatten(
            JaxModel(config=JaxConfig(**kw)).init(jax.random.key(0))).items()}
        ours = BERT4RecModel(config=BERT4RecConfig(**kw)).init(
            torch.Generator().manual_seed(0), "cpu")
        assert {k: tuple(v.shape) for k, v in flatten(ours).items()} \
            == jax_shapes


class TestRankTopK:

    @pytest.mark.parametrize("with_exclude", [False, True],
                             ids=["plain", "exclude"])
    def test_ids_and_scores_match_jax(self, with_exclude):
        kw = model_kwargs(use_fused_layer=True)
        jax_model = JaxModel(config=JaxConfig(**kw))
        model = BERT4RecModel(config=BERT4RecConfig(**kw))
        flat = random_params(jax_model, 3)
        feats = features(3)
        exclude = None
        if with_exclude:
            rng = np.random.default_rng(9)
            exclude = rng.integers(0, V, size=(B, 12)).astype(np.int32)
            exclude[:, -4:] = -1
        k = 7
        for probs in (False, True):
            ids_j, sc_j = jax_model.rank_top_k(
                to_jax(flat), {k_: jnp.asarray(v) for k_, v in feats.items()},
                k, exclude=None if exclude is None else jnp.asarray(exclude),
                with_probabilities=probs)
            ids_t, sc_t = model.rank_top_k(
                params_from_numpy(flat, "cpu"),
                {k_: torch.from_numpy(v) for k_, v in feats.items()}, k,
                exclude=None if exclude is None
                else torch.from_numpy(exclude),
                with_probabilities=probs)
            # tie-free logits: the random output bias spreads them apart
            np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
            np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j),
                                       **TOL)
            if exclude is not None:
                for row, ex in zip(ids_t[:, 0].numpy(), exclude):
                    assert not set(row) & set(ex[ex >= 0])


class TestTrainingMode:

    def test_training_routing_follows_the_jax_law(self):
        """With dropout active JAX fuses the layer only on the TPU; the
        port reads that as the card. At rate 0 both fuse everywhere."""
        enc = BERT4RecModel(config=BERT4RecConfig(
            **model_kwargs(use_fused_layer=True))).encoder
        assert not enc.fused_layer_routed(B, S, dropout_active=True,
                                          device="cpu")
        assert enc.fused_layer_routed(B, S, dropout_active=True,
                                      device="cuda")
        assert enc.fused_layer_routed(B, S, dropout_active=False,
                                      device="cpu")

    @pytest.mark.parametrize("fused", [True, False],
                             ids=["fused", "unfused"])
    def test_dropout_is_seeded_and_only_in_training(self, fused):
        kw = model_kwargs(use_fused_layer=fused, attention_dropout=0.2,
                          output_dropout=0.5)
        model = BERT4RecModel(config=BERT4RecConfig(**kw))
        params = params_from_numpy(random_params(JaxModel(config=JaxConfig(
            **kw)), 5), "cpu")
        feats = {k: torch.from_numpy(v) for k, v in features(5).items()}

        def run(**kw_):
            return model.apply(params, feats, **kw_)["mlm_logits"]

        eval_out = run()
        a, b = run(training=True, seed=3), run(training=True, seed=3)
        assert torch.equal(a, b)
        assert not torch.equal(a, run(training=True, seed=4))
        assert float((a - eval_out).abs().max()) > 1e-2
        # no seed, no dropout (the JAX encoder without an rng)
        if not fused:
            assert torch.equal(run(training=True), eval_out)

    def test_rate_zero_training_equals_eval(self):
        kw = model_kwargs(use_fused_layer=True, attention_dropout=0.0,
                          output_dropout=0.0)
        model = BERT4RecModel(config=BERT4RecConfig(**kw))
        params = params_from_numpy(random_params(JaxModel(config=JaxConfig(
            **kw)), 6), "cpu")
        feats = {k: torch.from_numpy(v) for k, v in features(6).items()}
        assert torch.equal(
            model.apply(params, feats, training=True, seed=1)["mlm_logits"],
            model.apply(params, feats)["mlm_logits"])


class TestSurfaceRepairs:
    """The JAX surface the port lacked before the flash slice: the
    wrapper's ``update_params``, ``BERT4RecConfig.to_json_file``,
    ``model_utils`` (popularity bias, ``rank_items``) and the model's
    ranking (``rank_with_candidates``, ``rank_full_vocab``,
    ``rank_items``, ``apply_prediction_mask``), on tie-free logits."""

    def test_wrapper_update_params_saves_what_jax_loads(self, tmp_path):
        from bert4rec_tpu.models import BERT4RecModelWrapper as JaxWrapper
        from bert4rec_tpu_torch.models import BERT4RecModelWrapper
        kw = model_kwargs()
        model = BERT4RecModel(config=BERT4RecConfig(**kw))
        flat = random_params(JaxModel(config=JaxConfig(**kw)), 21)
        wrapper = BERT4RecModelWrapper(model)
        with pytest.raises(RuntimeError):
            wrapper.save(tmp_path / "none", mode=2)
        params = params_from_numpy(flat, "cpu")
        wrapper.update_params(params)
        assert wrapper.params is params
        wrapper.save(tmp_path / "port", mode=2)
        jwrapper, _ = JaxWrapper.load(tmp_path / "port", mode=2)
        loaded = flatten(jwrapper.params)
        assert set(loaded) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(np.asarray(loaded[k]), v)
        jwrapper.update_params(to_jax(flat))   # the JAX call it mirrors

    def test_config_to_json_file_round_trips_like_jax(self, tmp_path):
        kw = model_kwargs(use_flash_attention=True, remat=True,
                          vocab_pad_to=8)
        ours = BERT4RecConfig(**kw)
        ours.to_json_file(tmp_path / "new" / "ours.json")
        JaxConfig(**kw).to_json_file(tmp_path / "theirs.json")
        assert BERT4RecConfig.from_json_file(tmp_path / "new" / "ours.json") \
            == ours
        assert json.loads((tmp_path / "new" / "ours.json").read_text()) \
            == json.loads((tmp_path / "theirs.json").read_text())
        assert JaxConfig.from_json_file(
            tmp_path / "new" / "ours.json").to_dict() == ours.to_dict()

    def test_init_output_bias_from_popularity_matches_jax(self):
        from bert4rec_tpu.models import model_utils as jax_utils
        from bert4rec_tpu_torch.models import model_utils
        kw = model_kwargs(vocab_pad_to=8)
        flat = random_params(JaxModel(config=JaxConfig(**kw)), 22)
        counts = np.random.default_rng(22).integers(0, 50, size=V - 5)
        params = params_from_numpy(flat, "cpu")
        before = params["mlm"]["output_bias"].clone()
        ours = model_utils.init_output_bias_from_popularity(params, counts,
                                                            smoothing=0.5)
        theirs = jax_utils.init_output_bias_from_popularity(
            to_jax(flat), counts, smoothing=0.5)
        np.testing.assert_allclose(ours["mlm"]["output_bias"].numpy(),
                                   np.asarray(theirs["mlm"]["output_bias"]),
                                   rtol=1e-6, atol=1e-6)
        assert ours["mlm"]["output_bias"].dtype == torch.float32
        assert torch.equal(params["mlm"]["output_bias"], before)
        assert ours["encoder"] is params["encoder"]
        with pytest.raises(ValueError):
            model_utils.init_output_bias_from_popularity(params, counts, 0.0)
        with pytest.raises(ValueError):
            model_utils.init_output_bias_from_popularity(
                params, np.ones(200))

    @pytest.mark.parametrize("mode", ["vocab", "embeddings", "row_items",
                                      "shared_items"])
    def test_model_utils_rank_items_matches_jax(self, mode):
        from bert4rec_tpu.models import model_utils as jax_utils
        from bert4rec_tpu_torch.models import model_utils
        rng = np.random.default_rng(23)
        emb = rng.normal(size=(V, H)).astype(np.float32)
        x = rng.normal(size=(B, 3, H if mode == "embeddings" else V)) \
            .astype(np.float32)
        items = {"row_items": rng.integers(0, V, size=(B, 3, 9)),
                 "shared_items": rng.permutation(V)[:9]}.get(mode)
        kw = {"embeddings": emb} if mode == "embeddings" else {}
        ours = model_utils.rank_items(
            torch.from_numpy(x),
            **{k: torch.from_numpy(v) for k, v in kw.items()},
            items=None if items is None else torch.from_numpy(items))
        theirs = jax_utils.rank_items(
            jnp.asarray(x), **{k: jnp.asarray(v) for k, v in kw.items()},
            items=None if items is None else jnp.asarray(items))
        np.testing.assert_array_equal(ours[0].numpy(), np.asarray(theirs[0]))
        np.testing.assert_allclose(ours[1].numpy(), np.asarray(theirs[1]),
                                   rtol=1e-5, atol=1e-6)

    def test_model_ranking_and_prediction_mask_match_jax(self):
        kw = model_kwargs(vocab_pad_to=8)
        jax_model = JaxModel(config=JaxConfig(**kw))
        model = BERT4RecModel(config=BERT4RecConfig(**kw))
        flat = random_params(jax_model, 24)
        feats = features(24)
        jp, tp = to_jax(flat), params_from_numpy(flat, "cpu")
        jf = {k: jnp.asarray(v) for k, v in feats.items()}
        tf = {k: torch.from_numpy(v) for k, v in feats.items()}
        masked = model.apply(tp, tf, apply_prediction_mask=True)
        jmasked = jax_model.apply(jp, jf, apply_prediction_mask=True)
        np.testing.assert_allclose(masked["mlm_logits"].numpy(),
                                   np.asarray(jmasked["mlm_logits"]), **TOL)
        assert (masked["mlm_logits"][..., :3] < -5e8).all()
        cand = np.random.default_rng(24).integers(3, V, size=(B, 3, 11))
        for ours, theirs in (
                (model.rank_with_candidates(tp, tf, torch.from_numpy(cand)),
                 jax_model.rank_with_candidates(jp, jf, jnp.asarray(cand))),
                (model.rank_full_vocab(tp, tf),
                 jax_model.rank_full_vocab(jp, jf)),
                (model.rank_items(tp, tf, cand),
                 jax_model.rank_items(jp, jf, cand)),
                (model.rank_items(tp, tf), jax_model.rank_items(jp, jf))):
            np.testing.assert_array_equal(ours[0].numpy(),
                                          np.asarray(theirs[0]))
            np.testing.assert_allclose(ours[1].numpy(), np.asarray(theirs[1]),
                                       rtol=1e-4, atol=1e-6)
        ids, probs = model.rank_full_vocab(tp, tf, with_probabilities=False)
        assert probs is None and ids.shape == (B, 3, 64)
