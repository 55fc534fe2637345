"""The laws of the port's mesh and partitioning (``core/mesh.py``,
``core/partitioning.py``) held against the JAX package's, with no process
group: ``MeshConfig``'s resolution and errors, the one-rank mesh, the
backend and device choice, the path rules and the warn-and-replicate law,
each rank's pieces against the shards JAX places on the same grid, the
batch slices, the block-wise top-k, and the dataset slices by 'data'
coordinate."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bert4rec_tpu.core import mesh as jax_mesh_lib
from bert4rec_tpu.core import partitioning as jax_part
from bert4rec_tpu.dataloaders.processed_dataset import (
    MaskingConfig as JaxMaskingConfig,
    ProcessedDataset as JaxProcessedDataset,
)
from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
from bert4rec_tpu.models import BERT4RecModel as JaxModel
from bert4rec_tpu.ops import sharded_topk as jax_topk
from bert4rec_tpu_torch import core
from bert4rec_tpu_torch.core import mesh as mesh_lib
from bert4rec_tpu_torch.core import partitioning
from bert4rec_tpu_torch.core.mesh import Mesh, MeshConfig
from bert4rec_tpu_torch.dataloaders.processed_dataset import (
    MaskingConfig, ProcessedDataset,
)
from bert4rec_tpu_torch.ops import sharded_topk
from bert4rec_tpu_torch.trainers import optimizers
from bert4rec_tpu_torch.utils.checkpoint import flatten

MODEL_KW = dict(vocab_size=61, hidden_size=16, num_layers=1,
                num_attention_heads=2, inner_dim=32, max_sequence_length=8,
                max_predictions_per_seq=2)


def _spec(p) -> tuple:
    """A JAX PartitionSpec as the port's tuple."""
    return tuple(p)


def _error(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


class TestMeshConfig:

    @pytest.mark.parametrize("n,mp,dp", [
        (8, 1, None), (8, 2, None), (8, 8, None), (8, 2, 4), (4, 2, 2),
        (6, 4, None), (8, 2, 2), (1, 1, None), (1, 2, None)])
    def test_resolves_and_refuses_as_jax(self, n, mp, dp):
        ours = MeshConfig(model_parallelism=mp, data_parallelism=dp)
        theirs = jax_mesh_lib.MeshConfig(model_parallelism=mp,
                                         data_parallelism=dp)
        want = _error(lambda: theirs.resolve(n))
        assert _error(lambda: ours.resolve(n)) == want
        if want is None:
            assert ours.resolve(n) == theirs.resolve(n)

    def test_axis_names_are_jaxs(self):
        assert (mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS) == \
            (jax_mesh_lib.DATA_AXIS, jax_mesh_lib.MODEL_AXIS)
        assert Mesh.axis_names == ("data", "model")


class TestOneRankWorld:

    def test_distributed_initialize_is_a_no_op_alone(self, monkeypatch):
        monkeypatch.delenv("MASTER_ADDR", raising=False)
        assert core.distributed_initialize() is None
        assert not torch.distributed.is_initialized()

    def test_create_mesh_without_a_process_group(self):
        mesh = core.create_mesh(device="cpu")
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.coords == {"data": 0, "model": 0}
        assert mesh.device == torch.device("cpu")
        assert mesh.device_mesh is None
        with pytest.raises(ValueError, match="does not divide device count"):
            core.create_mesh(MeshConfig(model_parallelism=2), device="cpu")

    def test_collectives_on_one_rank_axes_are_the_identity(self):
        mesh = Mesh(1, 1, 0, "cpu")
        x = torch.arange(6.0).reshape(3, 2).requires_grad_(True)
        assert mesh_lib.psum(mesh, x, "model") is x
        assert mesh_lib.gather_rows(mesh, x, "model") is x
        np.testing.assert_array_equal(mesh_lib.gather(mesh, x.detach(),
                                                      "data")[0], x.detach())
        np.testing.assert_array_equal(
            mesh_lib.all_reduce(mesh, x.detach().clone(), "data", "max"),
            x.detach())

    def test_a_non_mesh_raises_naming_it(self):
        assert mesh_lib.as_mesh(None, "here") is None
        mesh = Mesh(1, 1, 0, "cpu")
        assert mesh_lib.as_mesh(mesh, "here") is mesh
        with pytest.raises(TypeError, match="here.*dict"):
            mesh_lib.as_mesh({"data": 1}, "here")

    def test_placements(self):
        from torch.distributed.tensor import Replicate, Shard
        mesh = Mesh(1, 1, 0, "cpu")
        assert core.batch_sharding(mesh) == (Shard(0), Replicate())
        assert core.replicated_sharding(mesh) == (Replicate(), Replicate())


class TestBackend:

    @pytest.mark.parametrize("world,count,want", [
        (2, 1, "gloo"), (2, 2, "nccl"), (4, 8, "nccl"), (8, 4, "gloo")])
    def test_nccl_only_with_a_device_a_rank(self, monkeypatch, world, count,
                                            want):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
        monkeypatch.setattr(torch.distributed, "is_nccl_available",
                            lambda: True)
        assert mesh_lib.choose_backend(world, "cuda") == want
        assert mesh_lib.choose_backend(world, "cpu") == "gloo"

    def test_ranks_share_the_cards_there_are(self, monkeypatch):
        monkeypatch.delenv("LOCAL_RANK", raising=False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert {mesh_lib.rank_device(r, 2, "cuda") for r in (0, 1)} == \
            {torch.device("cuda", 0)}
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        assert [mesh_lib.rank_device(r, 4, "cuda").index
                for r in range(4)] == [0, 1, 2, 3]
        assert mesh_lib.rank_device(3, 4, "cpu") == torch.device("cpu")


def _jax_params(**over):
    model = JaxModel(config=JaxConfig(**{**MODEL_KW, **over}))
    return model.init(jax.random.key(0))


def _jax_grid(dp, mp):
    return jax_mesh_lib.create_mesh(
        jax_mesh_lib.MeshConfig(model_parallelism=mp),
        devices=jax.devices()[:dp * mp])


class TestPartitionRules:

    def test_param_specs_are_jaxs(self):
        params = _jax_params()
        want = {k: _spec(v) for k, v in flatten(
            jax_part.param_partition_specs(params)).items()}
        host = {k: np.asarray(v) for k, v in flatten(params).items()}
        assert flatten(core.param_partition_specs(host)) == want
        assert want["encoder/item_embeddings/embedding"] == ("model", None)
        assert want["mlm/output_bias"] == ("model",)

    @pytest.mark.parametrize("dp,mp,pad_to", [
        (1, 2, None), (1, 2, 4), (2, 2, 4), (2, 1, None), (1, 4, 4)])
    def test_shardings_warn_and_replicate_as_jax(self, dp, mp, pad_to):
        params = _jax_params(vocab_pad_to=pad_to)
        host = {k: np.asarray(v) for k, v in flatten(params).items()}
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = flatten(jax_part.param_shardings(_jax_grid(dp, mp),
                                                    params))
        with warnings.catch_warnings(record=True) as pw:
            warnings.simplefilter("always")
            got = flatten(core.param_shardings(Mesh(dp, mp, 0, "cpu"),
                                               host))
        assert {k: _spec(v.spec) for k, v in want.items()} == got
        assert len(jw) == len(pw)
        for j, p in zip(jw, pw):
            head = str(j.message).split(" cannot")[0]
            assert str(p.message).startswith(head)
            assert "replicating" in str(p.message)

    @pytest.mark.parametrize("dp,mp", [(1, 2), (2, 1), (2, 2), (2, 4)])
    def test_pieces_are_the_shards_jax_places(self, dp, mp):
        """Each rank's pieces equal the shard JAX puts on the device at
        the same (data, model) place of the grid."""
        params = _jax_params(vocab_pad_to=8)
        grid = _jax_grid(dp, mp)
        placed = flatten(jax.device_put(
            params, jax_part.param_shardings(grid, params)))
        host = {k: np.asarray(v) for k, v in flatten(params).items()}
        for rank in range(dp * mp):
            device = grid.devices.flat[rank]
            mine = flatten(partitioning.shard_state(
                Mesh(dp, mp, rank, "cpu"), host))
            for k, leaf in placed.items():
                shard = [s for s in leaf.addressable_shards
                         if s.device == device][0]
                np.testing.assert_array_equal(mine[k], np.asarray(shard.data),
                                              err_msg=(rank, k))

    def test_tensor_pieces_keep_requires_grad(self):
        t = torch.arange(16.0).reshape(8, 2).requires_grad_(True)
        out = partitioning.shard_flat(Mesh(1, 2, 1, "cpu"),
                                      {"a/item_embeddings/embedding": t,
                                       "w": t})
        piece = out["a/item_embeddings/embedding"]
        assert piece.requires_grad and piece.is_leaf
        np.testing.assert_array_equal(piece.detach(), t.detach()[4:])
        assert out["w"] is t

    def test_vocab_sharded_law(self):
        m2 = Mesh(1, 2, 0, "cpu")
        assert partitioning.vocab_sharded(m2, 32, 64)
        assert not partitioning.vocab_sharded(m2, 64, 64)     # whole
        assert not partitioning.vocab_sharded(m2, 61, 61)     # indivisible
        assert not partitioning.vocab_sharded(Mesh(2, 1, 0, "cpu"), 64, 64)
        assert not partitioning.vocab_sharded(None, 32, 64)


class TestBatches:

    def test_batch_specs_are_jaxs(self):
        b = {"a": np.zeros((4, 3), np.int32), "b": np.zeros((4,)),
             "c": np.zeros((4, 2, 5))}
        want = {k: _spec(v) for k, v in jax_part.make_batch_specs(
            {k: jnp.asarray(v) for k, v in b.items()}).items()}
        assert core.make_batch_specs(b) == want

    def test_global_batch_slices_and_refuses_as_jax(self):
        b = {"x": np.arange(12).reshape(6, 2), "y": np.arange(6)}
        for rank, rows in ((0, [0, 1, 2]), (1, [0, 1, 2]), (3, [3, 4, 5])):
            got = partitioning.place_batch(Mesh(2, 2, rank, "cpu"), b,
                                           local=False)
            np.testing.assert_array_equal(got["y"], rows)
            assert got["x"].shape == (3, 2)
        stacked = {"x": np.arange(24).reshape(2, 6, 2)}
        got = partitioning.place_batch(Mesh(3, 1, 2, "cpu"), stacked,
                                       stacked=True, local=False)
        np.testing.assert_array_equal(got["x"], stacked["x"][:, 4:])
        grid = _jax_grid(4, 1)
        want = _error(lambda: jax_part.place_batch(grid, b))
        assert want and _error(lambda: partitioning.place_batch(
            Mesh(4, 1, 0, "cpu"), b, local=False)) == want.replace(
                "{'data': 4, 'model': 1}", str({"data": 4, "model": 1}))

    def test_local_slices_need_equal_rows(self):
        mesh = Mesh(2, 1, 1, "cpu")
        got = partitioning.place_batch(mesh, {"x": np.ones((3, 2)),
                                              "y": np.ones(3)})
        assert got["x"].shape == (3, 2) and got["x"].device.type == "cpu"
        with pytest.raises(ValueError, match="disagree on its rows"):
            partitioning.place_batch(mesh, {"x": np.ones((3, 2)),
                                            "y": np.ones(4)})

    def test_dataset_slices_follow_the_data_coordinate(self):
        rng = np.random.default_rng(0)
        seqs = [rng.integers(3, 40, size=6).astype(np.int32)
                for _ in range(11)]
        kw = dict(max_seq_len=8, max_predictions_per_seq=2,
                  mask_token_id=1, pad_token_id=0, unk_token_id=2)
        ours = ProcessedDataset(seqs, MaskingConfig(**kw), lambda: 40)
        theirs = JaxProcessedDataset(seqs, JaxMaskingConfig(**kw),
                                     lambda: 40)
        for dp, mp in ((2, 2), (1, 4), (4, 1)):
            for rank in range(dp * mp):
                mesh = Mesh(dp, mp, rank, "cpu")
                got = ours.shard_for_process(mesh=mesh)
                want = theirs.shard_for_process(rank // mp, dp)
                assert [s.tolist() for s in got.sequences] == \
                    [s.tolist() for s in want.sequences]
        # without a mesh: (rank, world), JAX's process_index / count
        assert ours.shard_for_process(3, 4).cardinality() == 2


class TestTopK:

    @pytest.mark.parametrize("shards", [1, 2, 4, 7])
    def test_blocks_give_jaxs_top_k(self, shards):
        rng = np.random.default_rng(shards)
        logits = rng.normal(size=(3, 2, 28)).astype(np.float32)
        want = jax_topk.topk_over_vocab(jnp.asarray(logits), 5,
                                        vocab_shards=shards)
        got = sharded_topk.topk_over_vocab(torch.from_numpy(logits), 5,
                                           vocab_shards=shards)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])

    def test_exclusion_bias_of_a_block(self):
        excl = torch.tensor([[3, 9, -1, 17], [0, 12, 8, -1]])
        whole = sharded_topk.exclusion_bias(excl, 16)
        np.testing.assert_array_equal(
            whole, jax_topk.exclusion_bias(jnp.asarray(excl.numpy()), 16))
        for offset in (0, 8):
            np.testing.assert_array_equal(
                sharded_topk.exclusion_bias(excl, 8, offset=offset),
                whole[:, offset:offset + 8])


class TestClipNormHook:

    def test_the_hook_gives_the_norm_and_the_default_is_unchanged(self):
        """``sq_norm`` receives every leaf's sum of squares and its total
        is the clip's squared norm; the sum of them is the default's."""
        torch.manual_seed(0)
        params = {"a": torch.randn(4, 3), "b": torch.randn(5)}
        grads = {"a": torch.randn(4, 3) * 5, "b": torch.randn(5) * 5}
        seen = []

        def hook(sums):
            seen.append({k: float(v) for k, v in sums.items()})
            return sum(sums.values())

        runs = []
        for h in (None, hook):
            p = {k: v.clone() for k, v in params.items()}
            opt = optimizers.create_adam_w_optimizer(init_lr=0.1,
                                                     num_warmup_steps=0,
                                                     global_clipnorm=1.0)
            opt.update(grads, opt.init(p), p, sq_norm=h)
            runs.append(p)
        for k in params:
            torch.testing.assert_close(runs[0][k], runs[1][k], rtol=0,
                                       atol=0)
        assert seen == [{k: float((g * g).sum()) for k, g in grads.items()}]
