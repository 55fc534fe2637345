"""The JAX package's surface the port lacked, held against the JAX package
on the CPU: the trainer's constructor (``mesh``, ``eval_steps_per_call``)
and its optional checkpoint records, the encoder's and the model's config
round-trips, the package exports of ``utils``, ``ops``, ``models``,
``core`` and ``models.components``, ``utils.load_json_config``, the
per-sequence masking laws ``apply_dynamic_masking_task`` /
``mask_last_token_only``, ``ModelWrapper.delete_keys_from_meta``,
``prefetch``'s ``put_fn`` keyword and ``core.enable_fast_prng``; and the
arguments JAX's calls take: ``transformer_block``'s ``num_heads`` and
default rates, ``layers.dropout``'s ``training``,
``truncated_normal_init``'s ``dtype``, ``create_mesh``'s ``devices`` and
the exports' ``platforms``."""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bert4rec_tpu.apps as jax_apps
import bert4rec_tpu.core as jax_core
import bert4rec_tpu.models as jax_models
import bert4rec_tpu.models.components as jax_components
import bert4rec_tpu.ops as jax_ops
import bert4rec_tpu.utils as jax_utils
from bert4rec_tpu.core import mesh as jax_mesh
from bert4rec_tpu.dataloaders import dataloader_utils as jax_du
from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models import BERT4RecModel as JaxModel
from bert4rec_tpu.models import Bert4RecEncoder as JaxEncoder
from bert4rec_tpu.models import export as jax_export
from bert4rec_tpu.models.components import layers as JL
from bert4rec_tpu.models.components import transformer as jax_transformer
from bert4rec_tpu.models.model_wrapper import ModelWrapper as JaxWrapper
from bert4rec_tpu.trainers import BERT4RecTrainer as JaxTrainer
from bert4rec_tpu.utils import checkpoint as jax_ckpt
from bert4rec_tpu.utils import prefetch as jax_prefetch
from bert4rec_tpu_torch import apps, core, models, ops, utils
from bert4rec_tpu_torch.models import components, export
from bert4rec_tpu_torch.models.components import layers as L
from bert4rec_tpu_torch.models.components import transformer
from bert4rec_tpu_torch.dataloaders import dataloader_utils as du
from bert4rec_tpu_torch.models import (
    BERT4RecConfig, BERT4RecModel, Bert4RecEncoder, ModelWrapper,
)
from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
from bert4rec_tpu_torch.utils import checkpoint as ckpt
from bert4rec_tpu_torch.utils import prefetch as port_prefetch
from tests.test_torch_cuda_kernels import inputs_np, layer_params_np
from tests.test_torch_trainer import (
    OPT, config_kwargs, dataset, host_params, jax_trainer,
)


def port_trainer(params, **trainer_kw):
    trainer = BERT4RecTrainer(
        BERT4RecModel(config=BERT4RecConfig(**config_kwargs())),
        **trainer_kw)
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(**OPT),
        params=ckpt.params_from_numpy(params, "cpu"), device="cpu")
    return trainer


@pytest.fixture(scope="module")
def jax_state():
    trainer = jax_trainer()
    return host_params(trainer), trainer


class TestTrainerSurface:

    def test_constructor_takes_jax_arguments_in_jax_order(self):
        model = BERT4RecModel(config=BERT4RecConfig(**config_kwargs()))
        t = BERT4RecTrainer(model, None, 2, 1, 3)
        assert (t.mesh, t.steps_per_call, t.grad_accum_steps,
                t.eval_steps_per_call) == (None, 2, 1, 3)
        # a port mesh is taken (one rank here); anything else is named
        mesh = core.create_mesh(device="cpu")
        assert BERT4RecTrainer(model, mesh).mesh is mesh
        with pytest.raises(TypeError, match="BERT4RecTrainer.*object"):
            BERT4RecTrainer(model, mesh=object())
        with pytest.raises(ValueError, match="mutually exclusive"):
            BERT4RecTrainer(model, None, 2, 2)

    @pytest.mark.parametrize("k", [1, 3])
    def test_eval_steps_per_call_validates_as_jax(self, jax_state, k):
        """validate() with eval_steps_per_call = k (JAX: a stacked eval
        dispatch for full groups) gives JAX's metrics, the padded final
        batch inside a partial group included; and the port's own result
        is the same for every k."""
        params, _ = jax_state
        jt = JaxTrainer(JaxModel(config=JaxConfig(**config_kwargs())),
                        eval_steps_per_call=k)
        jt.initialize_model(rng=jax.random.key(0))
        jt.state = jax_state[1].state
        ours = port_trainer(params, eval_steps_per_call=k)
        single = port_trainer(params)
        val = dataset(n=72, seed=5)   # 5 batches of 16, the last padded
        got = ours.validate(val, batch_size=16, seed=2)
        theirs = jt.validate(val, batch_size=16, seed=2)
        assert got == single.validate(val, batch_size=16, seed=2)
        assert set(got) == set(theirs)
        for key in got:
            assert got[key] == pytest.approx(theirs[key], rel=1e-5, abs=1e-7)

    def test_checkpoint_without_epoch_or_best_monitor_loads(
            self, jax_state, tmp_path):
        """Each package's checkpoint without the optional ``epoch`` and
        ``best_monitor`` records (a legacy one) loads, leaving both unset;
        with them, both packages read them back. (Each package loads the
        other's train state too: tests/test_torch_train_state.py.)"""
        params, jt = jax_state
        ours = port_trainer(params)

        def strip(name):
            flat = ckpt.load_npz(tmp_path / f"{name}.npz")
            np.savez(tmp_path / f"{name}_legacy.npz",
                     **{k: v for k, v in flat.items()
                        if k not in ("epoch", "best_monitor")})

        for trainer, name in ((ours, "port"), (jt, "jax")):
            trainer._epochs_completed, trainer._best_monitor_value = 4, 0.25
            trainer.save_checkpoint(tmp_path / f"{name}.npz")
            strip(name)
        for trainer, name in ((port_trainer(params), "port"), (jt, "jax")):
            trainer.load_checkpoint(tmp_path / f"{name}.npz")
            assert (trainer._epochs_completed,
                    trainer._best_monitor_value) == (4, 0.25), name
            trainer.load_checkpoint(tmp_path / f"{name}_legacy.npz")
            assert (trainer._epochs_completed,
                    trainer._best_monitor_value) == (None, None), name
        assert port_trainer(params).state["step"] == 0


class TestConfigRoundTrips:

    @pytest.mark.parametrize("over", [{}, dict(use_flash_attention=True,
                                               remat=True)])
    def test_encoder_get_config_and_from_config(self, over):
        cfg = BERT4RecConfig(**config_kwargs(**over))
        enc = Bert4RecEncoder(cfg)
        assert enc.get_config() == JaxEncoder(
            JaxConfig(**config_kwargs(**over))).get_config()
        assert Bert4RecEncoder.from_config(enc.get_config()).config == cfg

    @pytest.mark.parametrize("name", ["BERT4RecModel", "SASRecModel"])
    def test_model_from_config(self, name):
        """``from_config`` builds the class it is called on, with the
        config JAX's class builds (SASRec's forces causal attention)."""
        cls, jax_cls = getattr(models, name), getattr(jax_models, name)
        d = BERT4RecConfig(**config_kwargs()).to_dict()
        model = cls.from_config(d, special_token_ids=[0, 1])
        assert type(model) is cls
        assert model.special_token_ids == [0, 1]
        assert model.get_config() == jax_cls.from_config(d).get_config()
        assert model.config == BERT4RecConfig.from_dict(model.get_config())


class TestExports:

    @pytest.mark.parametrize("port,jax_pkg,extra", [
        (utils, jax_utils, set()),
        (ops, jax_ops, set()),
        (models, jax_models, set()),
        (core, jax_core, {"resolve_device"}),
        (components, jax_components, set()),
        (apps, jax_apps, set()),
    ], ids=["utils", "ops", "models", "core", "models.components", "apps"])
    def test_package_exports_follow_jax(self, port, jax_pkg, extra):
        """Every JAX export is exported by the port: ``core``'s mesh and
        partitioning names (the multi-GPU layout), ``utils``' profiling
        trio, ``models.export`` / ``quantization`` and ``apps.Ranker`` /
        ``ArtifactRecommender``; ``core.resolve_device`` is the port's
        own."""
        assert set(port.__all__) == set(jax_pkg.__all__) | extra
        for name in port.__all__:
            assert getattr(port, name) is not None

    def test_components_export_the_encoder_and_its_modules(self):
        """``from ...models.components import Bert4RecEncoder, layers,
        transformer`` works on the port as on JAX, the encoder being the
        one ``models`` exports."""
        assert components.Bert4RecEncoder is Bert4RecEncoder
        assert components.layers.__name__ == \
            "bert4rec_tpu_torch.models.components.layers"
        assert components.transformer.__name__ == \
            "bert4rec_tpu_torch.models.components.transformer"

    def test_load_json_config(self, tmp_path):
        path = tmp_path / "c.json"
        path.write_text(json.dumps({"hidden_size": 64, "layers": [1, 2]}))
        assert utils.load_json_config(path) == \
            jax_utils.load_json_config(path)
        with pytest.raises(FileNotFoundError):
            utils.load_json_config(tmp_path / "absent.json")

    def test_pytree_exports_round_trip(self, tmp_path):
        tree = {"a": {"b": np.arange(3, dtype=np.float32)},
                "step": np.int64(7)}
        utils.save_pytree(tmp_path / "t.npz", tree)
        back = jax_ckpt.load_pytree(tmp_path / "t.npz", tree)
        np.testing.assert_array_equal(back["a"]["b"], tree["a"]["b"])
        got = utils.load_pytree(tmp_path / "t.npz",
                                {"a": {"b": torch.zeros(3)}, "step": 0})
        assert torch.equal(got["a"]["b"], torch.arange(3.0))
        assert got["step"] == 7


class TestSurfaceCalls:
    """Calls that work on the JAX package and work the same on the port."""

    @pytest.mark.parametrize("keys", ["custom", ["custom", "tokenizer"],
                                      ["absent"], []],
                             ids=["one_key", "a_list", "absent", "none"])
    def test_delete_keys_from_meta_follows_jax(self, keys):
        """A key or a list of keys leaves the meta config; an absent key is
        ignored."""
        jax_w, port_w = JaxWrapper(object()), ModelWrapper(object())
        for w in (jax_w, port_w):
            w.update_meta({"custom": 1, "last_trained": "2024-01-01"})
            w.delete_keys_from_meta(keys)
        assert port_w.get_meta() == jax_w.get_meta()
        assert "custom" not in port_w.get_meta() or keys in (["absent"], [])

    @pytest.mark.parametrize("depth", [1, 2, 5])
    def test_prefetch_takes_put_fn_by_keyword(self, depth):
        """``prefetch(iterator, put_fn=..., depth=...)`` as on JAX: the same
        parameter names, and the same items in order."""
        assert list(inspect.signature(port_prefetch.prefetch).parameters) \
            == list(inspect.signature(jax_prefetch.prefetch).parameters)
        items = list(range(7))
        put = lambda x: x * x + 1  # noqa: E731
        assert list(port_prefetch.prefetch(iter(items), put_fn=put,
                                           depth=depth)) == \
            list(jax_prefetch.prefetch(iter(items), put_fn=put,
                                       depth=depth)) == [put(x) for x in items]

    def test_enable_fast_prng_is_a_documented_no_op(self):
        """``core.enable_fast_prng()`` as ``bench.py`` calls it: no
        argument, no result, and no random stream moves (the port's
        dropout is a counter hash)."""
        assert inspect.signature(core.enable_fast_prng) == \
            inspect.signature(jax_core.enable_fast_prng)
        assert core.enable_fast_prng.__doc__
        before = torch.random.get_rng_state()
        assert core.enable_fast_prng() is None
        assert torch.equal(torch.random.get_rng_state(), before)


class TestPerSequenceMasking:

    @pytest.mark.parametrize("seed", [0, 42, 7])
    @pytest.mark.parametrize("rates", [(1.0, 0.0), (0.8, 0.1)])
    @pytest.mark.parametrize("dtype", [np.int64, np.int32])
    def test_apply_dynamic_masking_task_equals_jax(self, seed, rates, dtype):
        seq = np.arange(3, 23, dtype=dtype)
        kw = dict(max_selections_per_seq=5, mask_token_id=1,
                  special_token_ids=[0, 2], vocab_size=50,
                  selection_rate=0.2, mask_token_rate=rates[0],
                  random_token_rate=rates[1], seed=seed)
        ours = du.apply_dynamic_masking_task(seq, **kw)
        theirs = jax_du.apply_dynamic_masking_task(seq, **kw)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype == dtype
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("seq", [[5, 6, 7], [9]])
    def test_mask_last_token_only_equals_jax(self, seq):
        seq = np.array(seq, dtype=np.int64)
        ours = du.mask_last_token_only(seq, 1)
        theirs = jax_du.mask_last_token_only(seq, 1)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert seq[-1] != 1   # the input is not masked in place


def _params(fn) -> dict:
    return inspect.signature(fn).parameters


class TestJaxArguments:
    """Arguments JAX's calls take, which the port's took no part of."""

    def _block_inputs(self, heads=4):
        rng = np.random.default_rng(11)
        flat = ckpt.flatten(layer_params_np(rng, 32, heads, 64))
        x, mask = inputs_np(rng, 3, 10, 32)
        return flat, x, mask

    def test_transformer_block_takes_num_heads_with_jax_defaults(self):
        flat, x, mask = self._block_inputs()
        for name in ("num_heads", "output_dropout", "attention_dropout"):
            assert name in _params(transformer.transformer_block)
        for name in ("output_dropout", "attention_dropout"):
            assert _params(transformer.transformer_block)[name].default \
                == _params(jax_transformer.transformer_block)[name].default \
                == 0.1
        ref = jax_transformer.transformer_block(
            jax.tree_util.tree_map(jnp.asarray, ckpt.unflatten(flat)),
            jnp.asarray(x), JL.self_attention_mask(jnp.asarray(mask)),
            num_heads=4, inner_activation=JL.get_activation("gelu"))
        out = transformer.transformer_block(
            ckpt.params_from_numpy(flat, "cpu"), torch.from_numpy(x),
            L.self_attention_mask(torch.from_numpy(mask)), num_heads=4,
            inner_activation=L.get_activation("gelu"))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)
        with pytest.raises(ValueError, match="num_heads=2.*4 heads"):
            transformer.transformer_block(
                ckpt.params_from_numpy(flat, "cpu"), torch.from_numpy(x),
                L.self_attention_mask(torch.from_numpy(mask)), num_heads=2,
                inner_activation=L.get_activation("gelu"))

    def test_transformer_block_drops_at_the_default_rates(self):
        """With a seed and the default rates a training block drops, as
        JAX's does with an rng; rate 0 gives the eval output."""
        flat, x, mask = self._block_inputs()
        params = ckpt.params_from_numpy(flat, "cpu")
        args = (params, torch.from_numpy(x),
                L.self_attention_mask(torch.from_numpy(mask)))
        kw = dict(num_heads=4, inner_activation=L.get_activation("gelu"))
        evaluated = transformer.transformer_block(*args, **kw)
        dropped = transformer.transformer_block(*args, seed=3,
                                                training=True, **kw)
        kept = transformer.transformer_block(
            *args, seed=3, training=True, output_dropout=0.0,
            attention_dropout=0.0, **kw)
        jargs = (jax.tree_util.tree_map(jnp.asarray, ckpt.unflatten(flat)),
                 jnp.asarray(x), JL.self_attention_mask(jnp.asarray(mask)))
        jkw = dict(num_heads=4, inner_activation=JL.get_activation("gelu"))
        jax_eval = jax_transformer.transformer_block(*jargs, **jkw)
        jax_dropped = jax_transformer.transformer_block(
            *jargs, rng=jax.random.key(3), training=True, **jkw)
        assert not np.allclose(np.asarray(jax_dropped), np.asarray(jax_eval))
        assert not torch.allclose(dropped, evaluated)
        assert torch.equal(kept, evaluated)

    @pytest.mark.parametrize("rate", [0.0, 0.3])
    def test_dropout_takes_training(self, rate):
        x = torch.arange(1.0, 2001.0)
        assert "training" in _params(L.dropout)
        assert torch.equal(L.dropout(x, rate, 7, training=False), x)
        np.testing.assert_array_equal(
            np.asarray(JL.dropout(jax.random.key(7), jnp.asarray(x.numpy()),
                                  rate, False)), x.numpy())
        dropped = L.dropout(x, rate, 7, training=True)
        assert torch.equal(dropped, L.dropout(x, rate, 7))
        kept = float((dropped != 0).float().mean())
        assert abs(kept - (1 - rate)) < 0.05
        assert torch.equal(dropped[dropped != 0], x[dropped != 0]
                           / (1 - rate))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["fp32", "bf16"])
    def test_truncated_normal_init_takes_dtype(self, dtype):
        """Sampled in fp32, cast, then scaled in ``dtype`` (JAX's order):
        JAX's dtype for the same name, the fp32 draw's values cast."""
        assert _params(L.truncated_normal_init)["dtype"].default \
            == torch.float32
        out = L.truncated_normal_init(torch.Generator().manual_seed(3),
                                      (64, 8), 0.02, dtype=dtype)
        unit = L.truncated_normal_init(torch.Generator().manual_seed(3),
                                       (64, 8), 1.0)
        jdtype = {torch.float32: jnp.float32,
                  torch.bfloat16: jnp.bfloat16}[dtype]
        ref = JL.truncated_normal_init(jax.random.key(3), (64, 8), 0.02,
                                       jdtype)
        assert out.dtype == dtype and str(ref.dtype) == \
            str(dtype).removeprefix("torch.")
        assert torch.equal(out, unit.to(dtype) * 0.02)
        assert float(out.float().abs().max()) <= 0.04 + 1e-3
        meta = L.truncated_normal_init(None, (2, 3), 0.02, device="meta",
                                       dtype=dtype)
        assert meta.is_meta and meta.dtype == dtype

    def test_create_mesh_takes_the_worlds_devices(self):
        """``devices`` lists the world's devices: a one-rank world runs on
        its one entry, with JAX's mesh shape; a list of another length,
        or beside ``device``, raises."""
        assert list(_params(core.create_mesh))[:2] == \
            list(_params(jax_mesh.create_mesh))
        mesh = core.create_mesh(devices=["cpu"])
        jmesh = jax_mesh.create_mesh(devices=jax.devices()[:1])
        assert mesh.device.type == "cpu"
        assert (mesh.size("data"), mesh.size("model")) == \
            tuple(jmesh.shape.values())
        assert core.create_mesh(None, [torch.device("cpu")]).device.type \
            == "cpu"
        with pytest.raises(ValueError, match="2 devices for a world of 1"):
            core.create_mesh(devices=["cpu", "cpu"])
        with pytest.raises(ValueError, match="not both"):
            core.create_mesh(devices=["cpu"], device="cpu")

    @pytest.mark.parametrize("fn", ["export_top_k", "export_score_candidates"])
    def test_exports_take_platforms(self, fn):
        """``platforms`` as JAX's exports take it: the params' own device
        exports; another platform raises, naming the rule."""
        assert "platforms" in _params(getattr(export, fn))
        assert "platforms" in _params(getattr(jax_export, fn))
        model = BERT4RecModel(config=BERT4RecConfig(
            vocab_size=30, hidden_size=16, num_layers=1,
            num_attention_heads=2, inner_dim=32, max_sequence_length=8,
            max_predictions_per_seq=2))
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        call = getattr(export, fn)
        arg = 3
        plain = call(model, params, arg, batch_size=2)
        named = call(model, params, arg, batch_size=2, platforms=["cpu"])
        ids = torch.randint(3, 30, (2, 8), dtype=torch.int32)
        args = [ids, torch.ones_like(ids),
                torch.tensor([[1, 5], [0, 7]], dtype=torch.int32)]
        if fn == "export_score_candidates":
            args.append(torch.randint(3, 30, (2, 2, 3), dtype=torch.int32))
        for a, b in zip(torch.utils._pytree.tree_leaves(
                plain.module()(*args)),
                torch.utils._pytree.tree_leaves(named.module()(*args))):
            assert torch.equal(a, b)
        for bad in (["tpu"], ["cpu", "cuda"], ["gpu"], []):
            with pytest.raises(ValueError, match="runs on the device its "
                               "params lie on \\(cpu\\)"):
                call(model, params, arg, platforms=bad)
