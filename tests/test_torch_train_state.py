"""The train state crosses between the two packages on the CPU: the port's
checkpoint is written in the JAX trainer's layout (params, optax's
``opt_state/1/0`` Adam state and ``opt_state/1/2`` schedule count, ``step``
int32, ``rng`` as JAX's key data) and JAX's unmodified ``load_checkpoint``
restores it; the port restores JAX's file and its own earlier layout;
every leaf survives a round trip bit for bit; a run resumed across the
packages at dropout 0 matches one package's uninterrupted run; the seed <->
rng law holds at the edges of a 32-bit word; other key data raises."""

import jax
import numpy as np
import pytest
import torch

from bert4rec_tpu.utils import checkpoint as jax_ckpt
from bert4rec_tpu_torch.trainers import optimizers
from bert4rec_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_trainer import (
    dataset, host_params, jax_trainer, port_trainer,
)

SEEDS = [0, 42, 2 ** 32 - 1, 2 ** 32 + 7, 2 ** 63 - 1]
TRAIN = dict(batch_size=16, steps_per_epoch=1, verbose=False)


def jax_leaves(trainer) -> dict:
    """JAX's train state as the path-keyed numpy leaves it saves."""
    flat = jax.tree_util.tree_flatten_with_path(trainer.state)[0]
    return {jax_ckpt._path_key(p): np.asarray(v) for p, v in flat}


def port_leaves(trainer) -> dict:
    """The port's train state as path-keyed numpy leaves."""
    state = trainer.state
    out = {f"params/{k}": v.detach().numpy()
           for k, v in ckpt.flatten(state["params"]).items()}
    for name in ("mu", "nu"):
        out.update({f"opt/{name}/{k}": v.numpy() for k, v in
                    ckpt.flatten(state["opt_state"][name]).items()})
    out["count"] = np.asarray(state["opt_state"]["count"])
    out["step"] = np.asarray(state["step"])
    return out


def close_rel(a: np.ndarray, b: np.ndarray, rel: float) -> bool:
    """``|a - b| <= rel |b|`` in the 2-norm (a leaf's relative error)."""
    return np.linalg.norm(a - b) <= rel * np.linalg.norm(b)


@pytest.fixture(scope="module")
def jax_two_steps():
    """A JAX trainer after two single-step epochs, and its init params."""
    trainer = jax_trainer()
    init = host_params(trainer)
    trainer.train(dataset(), epochs=2, **TRAIN)
    return init, trainer


class TestLayout:

    def test_port_file_has_jax_keys_dtypes_and_shapes(self, jax_two_steps,
                                                      tmp_path):
        """The port writes every key JAX writes, with JAX's dtype and shape,
        and one more: its whole ``seed``."""
        init, jt = jax_two_steps
        jt.save_checkpoint(tmp_path / "jax.npz")
        port = port_trainer(init)
        port.train(dataset(), epochs=2, **TRAIN)
        port.save_checkpoint(tmp_path / "port.npz")
        theirs = ckpt.load_npz(tmp_path / "jax.npz")
        ours = ckpt.load_npz(tmp_path / "port.npz")
        assert set(ours) == set(theirs) | {"seed"}
        for key, value in theirs.items():
            assert (ours[key].dtype, ours[key].shape) == \
                (value.dtype, value.shape), key
        assert ours["opt_state/1/0/count"] == ours["opt_state/1/2/count"] \
            == ours["step"] == 2

    def test_jax_file_round_trips_through_the_port_bit_for_bit(
            self, jax_two_steps, tmp_path):
        """JAX -> port: every leaf equals JAX's state; port -> disk: every
        JAX leaf is written back with the bits it was read with."""
        init, jt = jax_two_steps
        jt.save_checkpoint(tmp_path / "jax.npz")
        port = port_trainer(init)
        port.load_checkpoint(tmp_path / "jax.npz")
        theirs = jax_leaves(jt)
        ours = port_leaves(port)
        for key, value in theirs.items():
            if key.startswith("params/"):
                np.testing.assert_array_equal(ours[key], value, err_msg=key)
            elif key.startswith("opt_state/1/0/mu/") or \
                    key.startswith("opt_state/1/0/nu/"):
                name, path = key[len("opt_state/1/0/"):].split("/", 1)
                np.testing.assert_array_equal(ours[f"opt/{name}/{path}"],
                                              value, err_msg=key)
        assert ours["count"] == ours["step"] == int(theirs["step"]) == 2
        assert port.state["seed"] == 0
        port.save_checkpoint(tmp_path / "again.npz")
        again = ckpt.load_npz(tmp_path / "again.npz")
        for key, value in ckpt.load_npz(tmp_path / "jax.npz").items():
            assert again[key].dtype == value.dtype, key
            np.testing.assert_array_equal(again[key], value, err_msg=key)

    def test_jax_load_checkpoint_restores_a_port_file(self, jax_two_steps,
                                                      tmp_path):
        """port -> JAX: JAX's own ``load_checkpoint`` restores the port's
        file, every leaf equal to the port's state."""
        init, _ = jax_two_steps
        port = port_trainer(init)
        port.train(dataset(), epochs=3, **TRAIN)
        port._best_monitor_value = 0.5
        port.save_checkpoint(tmp_path / "port.npz")
        jt = jax_trainer()
        jt.load_checkpoint(tmp_path / "port.npz")
        theirs, ours = jax_leaves(jt), port_leaves(port)
        for key, value in theirs.items():
            if key.startswith("params/"):
                np.testing.assert_array_equal(value, ours[key], err_msg=key)
            elif key.startswith(("opt_state/1/0/mu/",
                                 "opt_state/1/0/nu/")):
                name, path = key[len("opt_state/1/0/"):].split("/", 1)
                np.testing.assert_array_equal(
                    value, ours[f"opt/{name}/{path}"], err_msg=key)
        assert int(theirs["opt_state/1/0/count"]) == \
            int(theirs["opt_state/1/2/count"]) == int(theirs["step"]) == 3
        assert theirs["step"].dtype == np.int32
        np.testing.assert_array_equal(
            theirs["rng"], jax.random.key_data(jax.random.key(0)))
        assert (jt._epochs_completed, jt._best_monitor_value) == (3, 0.5)

    def test_pre_layout_port_checkpoint_still_loads(self, jax_two_steps,
                                                    tmp_path):
        """A checkpoint in the port's earlier layout (``opt_state/{count,
        mu,nu}``, int64 ``step`` and ``seed``, no ``rng``) resumes with
        every leaf and the seed unchanged."""
        init, _ = jax_two_steps
        port = port_trainer(init)
        port.state["seed"] = 2 ** 40 + 3
        port.train(dataset(), epochs=2, **TRAIN)
        state = port.state
        legacy = {f"params/{k}": v.detach().numpy()
                  for k, v in ckpt.flatten(state["params"]).items()}
        for name in ("mu", "nu"):
            legacy.update({f"opt_state/{name}/{k}": v.numpy() for k, v in
                           ckpt.flatten(state["opt_state"][name]).items()})
        legacy.update({"opt_state/count": np.int64(2), "step": np.int64(2),
                       "seed": np.int64(state["seed"]),
                       "epoch": np.int32(2), "best_monitor": np.nan})
        np.savez(tmp_path / "legacy.npz", **legacy)
        other = port_trainer(init)
        other.load_checkpoint(tmp_path / "legacy.npz")
        a, b = port_leaves(port), port_leaves(other)
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert other.state["seed"] == 2 ** 40 + 3
        assert other._epochs_completed == 2
        assert all(v.requires_grad for v in
                   ckpt.flatten(other.state["params"]).values())

    def test_counts_that_differ_raise(self, jax_two_steps, tmp_path):
        init, jt = jax_two_steps
        jt.save_checkpoint(tmp_path / "jax.npz")
        flat = ckpt.load_npz(tmp_path / "jax.npz")
        flat["opt_state/1/2/count"] = np.int32(5)
        np.savez(tmp_path / "bad.npz", **flat)
        with pytest.raises(ValueError, match="one count"):
            port_trainer(init).load_checkpoint(tmp_path / "bad.npz")
        assert optimizers.optax_count(
            ckpt.load_npz(tmp_path / "jax.npz")) == 2


class TestSeedRngLaw:

    @pytest.mark.parametrize("seed", SEEDS)
    def test_written_rng_is_jax_key_data(self, seed):
        np.testing.assert_array_equal(
            ckpt.rng_key_data(seed),
            np.asarray(jax.random.key_data(jax.random.key(seed))))
        assert ckpt.rng_key_data(seed).dtype == np.uint32

    @pytest.mark.parametrize("seed", SEEDS)
    def test_seed_survives_in_each_direction(self, jax_two_steps, seed,
                                             tmp_path):
        """port -> port keeps the whole seed; a JAX file (no ``seed``)
        gives ``hi << 32 | lo`` of its key, i.e. the seed mod 2**32; the
        port's file carries JAX's key for its seed."""
        init, _ = jax_two_steps
        port = port_trainer(init)
        port.state["seed"] = seed
        port.save_checkpoint(tmp_path / "port.npz")
        stored = ckpt.load_npz(tmp_path / "port.npz")
        np.testing.assert_array_equal(
            stored["rng"], jax.random.key_data(jax.random.key(seed)))
        other = port_trainer(init)
        other.load_checkpoint(tmp_path / "port.npz")
        assert other.state["seed"] == seed
        del stored["seed"]
        np.savez(tmp_path / "as_jax.npz", **stored)
        other.load_checkpoint(tmp_path / "as_jax.npz")
        assert other.state["seed"] == seed % 2 ** 32
        assert ckpt.seed_from_key_data(
            np.array([3, 9], np.uint32)) == 3 << 32 | 9

    def test_other_key_data_raises(self, jax_two_steps, tmp_path):
        """The 'rbg' PRNG's four words (JAX's ``enable_fast_prng``) and a
        wrong dtype are refused, naming the key data; nothing guesses a
        seed."""
        init, jt = jax_two_steps
        jt.save_checkpoint(tmp_path / "jax.npz")
        flat = ckpt.load_npz(tmp_path / "jax.npz")
        flat["rng"] = np.asarray(jax.random.key_data(
            jax.random.key(0, impl="rbg")))
        np.savez(tmp_path / "rbg.npz", **flat)
        with pytest.raises(ValueError, match=r"shape \(4,\)"):
            port_trainer(init).load_checkpoint(tmp_path / "rbg.npz")
        with pytest.raises(ValueError, match="int64"):
            ckpt.seed_from_key_data(np.array([0, 1], np.int64))

    def test_seed_and_a_foreign_rng_raise(self, jax_two_steps, tmp_path):
        init, _ = jax_two_steps
        port = port_trainer(init)
        port.save_checkpoint(tmp_path / "port.npz")
        flat = ckpt.load_npz(tmp_path / "port.npz")
        flat["rng"] = np.array([0, 1], np.uint32)
        np.savez(tmp_path / "bad.npz", **flat)
        with pytest.raises(ValueError, match="not its key"):
            port_trainer(init).load_checkpoint(tmp_path / "bad.npz")


class TestResumeAcrossPackages:
    """k = 2 steps in one package, saved; n = 2 more in the other through
    ``train(checkpoint_path=...)`` (auto-resume at the file's epoch); held
    against one package's uninterrupted k + n steps at dropout 0. Loss per
    step within 1e-5 relative; each param leaf within 1e-5 relative in the
    2-norm (fp32 sums in another order, through Adam)."""

    K, N = 2, 2

    @pytest.fixture(scope="class")
    def jax_whole(self):
        trainer = jax_trainer()
        init = host_params(trainer)
        hist = trainer.train(dataset(), epochs=self.K + self.N, **TRAIN)
        return init, hist.history["loss"], host_params(trainer)

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_resume_matches_the_uninterrupted_run(self, jax_whole, direction,
                                                  tmp_path):
        init, jloss, jparams = jax_whole
        path = tmp_path / "state.npz"
        first = jax_trainer() if direction == "jax_to_port" \
            else port_trainer(init)
        hist_k = first.train(dataset(), epochs=self.K, **TRAIN)
        first.save_checkpoint(path)
        second = port_trainer(init) if direction == "jax_to_port" \
            else jax_trainer()
        hist_n = second.train(dataset(), checkpoint_path=path,
                              epochs=self.K + self.N, **TRAIN)
        assert int(second.state["step"]) == self.K + self.N
        losses = hist_k.history["loss"] + hist_n.history["loss"]
        np.testing.assert_allclose(losses, jloss, rtol=1e-5)
        theirs = host_params(second)
        for key, value in jparams.items():
            assert close_rel(theirs[key], value, 1e-5), key
        assert max(np.abs(jparams[k] - init[k]).max() for k in init) > 1e-3
