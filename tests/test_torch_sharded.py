"""The port's ``(data, model)`` layout held against the JAX package's mesh
paths on the CPU. Each topology's gloo ranks are started once for the
module (``tools/mesh_run.py``); every rank runs the ``rank_*`` checks
below on its slice of the same numpy inputs, and the tests compare what
the ranks wrote with JAX's function on a ``create_mesh`` mesh of the same
shape (8 virtual CPU devices, interpret-mode kernels) and with the port's
own one-process run.

Tolerances: the loss within 2e-5 relative, the accuracy counts equal,
every gradient within 1e-5 of its scale, top-k ids, evaluation ranks and
metrics equal (tie-free logits), params after two optimizer steps within
2e-5. The rank checks import neither JAX nor the JAX package."""

import pathlib

import numpy as np
import pytest
import torch

from bert4rec_tpu_torch.core import partitioning
from bert4rec_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS
from bert4rec_tpu_torch.models import BERT4RecConfig, BERT4RecModel
from bert4rec_tpu_torch.tools import mesh_run
from bert4rec_tpu_torch.utils.checkpoint import flatten, params_from_numpy

THIS = pathlib.Path(__file__).resolve()
TOPOLOGIES = [(1, 2), (2, 1), (2, 2)]
TOPO_IDS = [f"data{d}_model{m}" for d, m in TOPOLOGIES]
V, SEQ, PRED, CAND, K = 61, 16, 4, 6, 5
MODEL_KW = dict(vocab_size=V, hidden_size=32, num_layers=2,
                num_attention_heads=4, inner_dim=64, max_sequence_length=SEQ,
                max_predictions_per_seq=PRED, attention_dropout=0.0,
                output_dropout=0.0, use_fused_layer=True,
                use_fused_loss=True)
PAD_TO = 4          # 61 -> 64 rows: 'model' of 2 divides it
OPT = dict(init_lr=1e-2, num_warmup_steps=1, num_train_steps=100,
           global_clipnorm=0.05)   # under the gradients' norm: clips
MASK_KW = dict(max_seq_len=SEQ, max_predictions_per_seq=PRED,
               mask_token_id=1, pad_token_id=0, unk_token_id=2,
               masked_lm_rate=0.3)
N_EVAL = 24
# 24 rows (12 a 'data' rank) in batches of 5 end in a padded batch
EVAL_BATCH = {"full": 5, "host": 5, "device": 4}
GLOBAL_B = 8


# --------------------------------------------------------------------------- #
# inputs (numpy, made from seeds; written once per topology)
# --------------------------------------------------------------------------- #

def loss_inputs(rows=64, w=32, v=4096, vocab_size=4090, seed=0):
    """JAX's test shapes, with a pad every 7th row, labels on a shard
    boundary, and more pads in the second half (unequal n_valid)."""
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(rows, w)).astype(np.float32)
    table = rng.normal(size=(v, w)).astype(np.float32) * 0.05
    bias = rng.normal(size=(v,)).astype(np.float32) * 0.1
    labels = rng.integers(0, vocab_size, size=rows).astype(np.int32)
    labels[::7] = 0
    labels[3] = v // 2
    labels[5] = v // 4
    labels[40:46] = 0
    return hidden, table, bias, labels, vocab_size


def batch(seed, b=GLOBAL_B):
    """A feature batch whose second half holds fewer valid positions."""
    rng = np.random.default_rng(seed + 100)
    ids = rng.integers(3, V, size=(b, SEQ)).astype(np.int32)
    lengths = rng.integers(PRED, SEQ + 1, size=b)
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)
    positions = np.stack([np.sort(rng.choice(int(n), size=PRED,
                                             replace=False))
                          for n in lengths]).astype(np.int32)
    labels = rng.integers(3, V, size=(b, PRED)).astype(np.int32)
    n_valid = np.where(np.arange(b) < b // 2, PRED, 1)
    weights = (np.arange(PRED)[None, :] < n_valid[:, None]).astype(
        np.float32)
    return {"input_word_ids": ids * mask, "input_mask": mask,
            "masked_lm_positions": positions,
            "masked_lm_ids": labels * weights.astype(np.int32),
            "masked_lm_weights": weights}


def eval_sequences(seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, V, size=int(rng.integers(6, SEQ + 4)))
            .astype(np.int32) for _ in range(N_EVAL)]


def write_inputs(out: pathlib.Path, flat_params: dict, flat_unpadded: dict,
                 words) -> dict:
    rng = np.random.default_rng(11)
    seqs = eval_sequences()
    inp = {f"p/{k}": v for k, v in flat_params.items()}
    inp.update({f"u/{k}": v for k, v in flat_unpadded.items()})
    for i in range(2):
        inp.update({f"b{i}/{k}": v for k, v in batch(i).items()})
    inp["candidates"] = rng.integers(0, V, size=(GLOBAL_B, PRED, CAND)) \
        .astype(np.int32)
    excl = np.full((GLOBAL_B, 6), -1, np.int32)
    excl[:, :3] = rng.integers(0, V, size=(GLOBAL_B, 3))
    inp["exclude"] = excl
    inp["seqs"] = np.concatenate(seqs)
    inp["seq_lengths"] = np.asarray([len(s) for s in seqs])
    inp["words"] = np.asarray(words)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "inputs.npz", **inp)
    return inp


# --------------------------------------------------------------------------- #
# the rank side (run by tools/mesh_run.py in each rank's process)
# --------------------------------------------------------------------------- #

def _inputs(out) -> dict:
    with np.load(pathlib.Path(out) / "inputs.npz") as f:
        return dict(f)


def _slice(mesh, arr):
    n = arr.shape[0] // mesh.size(DATA_AXIS)
    d = mesh.index(DATA_AXIS)
    return arr[d * n:(d + 1) * n]


def _model(**over):
    return BERT4RecModel(config=BERT4RecConfig(**{**MODEL_KW, **over}))


def _params(mesh, inp, prefix="p/"):
    flat = {k[len(prefix):]: v for k, v in inp.items()
            if k.startswith(prefix)}
    return partitioning.shard_state(mesh, params_from_numpy(flat, "cpu"))


def _batch(mesh, inp, i):
    return {k[3:]: torch.from_numpy(_slice(mesh, v))
            for k, v in inp.items() if k.startswith(f"b{i}/")}


def _grads(loss, params) -> dict:
    flat = flatten(params)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    return {f"g/{k}": (torch.zeros_like(p) if g is None else g)
            for (k, p), g in zip(flat.items(), grads)}


def _requires_grad(params):
    for v in flatten(params).values():
        v.requires_grad_(True)
    return params


def rank_loss(mesh, out):
    """The sharded loss and its gradients on this rank's rows and block."""
    from bert4rec_tpu_torch.ops import sharded_mlm_loss as sml
    hidden, table, bias, labels, vocab = loss_inputs()
    mp, m = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    vl = table.shape[0] // mp
    h = torch.tensor(_slice(mesh, hidden), requires_grad=True)
    t = torch.tensor(table[m * vl:(m + 1) * vl], requires_grad=True)
    b = torch.tensor(bias[m * vl:(m + 1) * vl], requires_grad=True)
    loss, cv, ca, nv = sml.sharded_fused_mlm_loss(
        h, t, b, torch.from_numpy(_slice(mesh, labels)), vocab, mesh)
    loss.backward()
    _, logs = sml.sharded_mlm_loss_and_metrics(
        h.detach()[None], t.detach(), b.detach(),
        torch.from_numpy(_slice(mesh, labels))[None], vocab, mesh)
    return {"loss": loss, "cv": cv, "ca": ca, "nv": nv, "dh": h.grad,
            "dt": t.grad, "db": b.grad, **logs}


def rank_model(mesh, out):
    """The model's mesh paths on this rank's pieces and slice."""
    inp = _inputs(out)
    model = _model(vocab_pad_to=PAD_TO)
    params = _requires_grad(_params(mesh, inp))
    b = _batch(mesh, inp, 0)
    res = {"table_rows": params["encoder"]["item_embeddings"]["embedding"]
           .shape[0]}
    loss, logs = model.loss_and_metrics(params, b, mesh=mesh)
    res.update({"loss": loss, **logs, **_grads(loss, params)})
    with torch.no_grad():
        cand = torch.from_numpy(_slice(mesh, inp["candidates"]))
        excl = torch.from_numpy(_slice(mesh, inp["exclude"]))
        res["scores"] = model.score_candidates(params, b, cand, mesh=mesh)
        ids, vals = model.rank_top_k(params, b, K, mesh=mesh, exclude=excl)
        pids, probs = model.rank_top_k(params, b, K, mesh=mesh,
                                       exclude=excl, with_probabilities=True)
        res.update(top_ids=ids, top_vals=vals, prob_ids=pids, probs=probs)
        res["full_ranks"] = model.gt_ranks_full_vocab(params, b,
                                                      exclude=excl,
                                                      mesh=mesh)
        res["logits"] = model.apply(params, b, mesh=mesh)["mlm_logits"]
    # a vocab the 'model' axis does not divide: replicated, with the
    # unsharded loss and the global means over 'data'
    model_u = _model()
    with pytest.warns(UserWarning, match="replicating") \
            if mesh.size(MODEL_AXIS) > 1 else _null():
        params_u = _requires_grad(_params(mesh, inp, "u/"))
    loss_u, logs_u = model_u.loss_and_metrics(params_u, b, mesh=mesh)
    res.update({"u_loss": loss_u, **{f"u_{k}": v for k, v in logs_u.items()},
                **{f"u_{k}": v for k, v in _grads(loss_u, params_u).items()}})
    return res


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _optimizer():
    from bert4rec_tpu_torch.trainers import optimizers
    return optimizers.create_adam_w_optimizer(**OPT)


def _trainer(mesh, inp, **over):
    from bert4rec_tpu_torch.trainers import BERT4RecTrainer
    trainer = BERT4RecTrainer(_model(vocab_pad_to=PAD_TO, **over), mesh=mesh)
    flat = {k[2:]: v for k, v in inp.items() if k.startswith("p/")}
    trainer.initialize_model(optimizer=_optimizer(),
                             params=params_from_numpy(flat, "cpu"), seed=3)
    return trainer


def rank_trainer(mesh, out):
    """Two optimizer steps on this rank's slices of two global batches,
    the gathered params, a checkpoint written and read back, and the
    dropout streams of the ranks."""
    from bert4rec_tpu_torch.models.components import layers as L
    inp = _inputs(out)
    trainer = _trainer(mesh, inp)
    res = {}
    for i in range(2):
        host = {k[3:]: _slice(mesh, v) for k, v in inp.items()
                if k.startswith(f"b{i}/")}
        logs = trainer.train_step(trainer._put_batch(host))
        res.update({f"step{i}/{k}": v for k, v in logs.items()})
    res.update({f"p/{k}": v for k, v in
                flatten(trainer.gathered_params()).items()})
    trainer.save_checkpoint(pathlib.Path(out) / "ckpt.npz")
    again = _trainer(mesh, inp)
    again.load_checkpoint(pathlib.Path(out) / "ckpt.npz")
    for k, v in flatten(again.params).items():
        torch.testing.assert_close(v, flatten(trainer.params)[k], rtol=0,
                                   atol=0)
    assert again.state["step"] == 2
    # dropout: the step seed of this rank and its keep mask at rate 0.3
    res["step_seed"] = np.int64(trainer._step_seed())
    res["keep"] = L.dropout(torch.ones(20000), 0.3,
                            trainer._step_seed()) > 0
    return res


def rank_eval(mesh, out):
    """The evaluator (full catalog, device and host negatives),
    evaluate_scorer and the Recommender on this rank's slice."""
    import functools

    from bert4rec_tpu_torch import evaluation
    from bert4rec_tpu_torch.apps import Recommender
    from bert4rec_tpu_torch.dataloaders import BERT4RecDataloader, samplers
    from bert4rec_tpu_torch.dataloaders.processed_dataset import (
        MaskingConfig, ProcessedDataset,
    )
    from bert4rec_tpu_torch.evaluation import BERT4RecEvaluator
    from bert4rec_tpu_torch.evaluation import baselines
    from bert4rec_tpu_torch.evaluation import markov_oracle as mo
    inp = _inputs(out)
    model = _model(vocab_pad_to=PAD_TO)
    params = _params(mesh, inp)
    seqs = np.split(inp["seqs"], np.cumsum(inp["seq_lengths"])[:-1])
    ds = ProcessedDataset(seqs, MaskingConfig(**MASK_KW), lambda: V,
                          finetuning=np.full(len(seqs), True), task="mlm") \
        .shard_for_process(mesh=mesh)
    source = [int(t) for s in seqs for t in s]
    kw = dict(source=source, vocab=list(dict.fromkeys(source)),
              sample_size=12, seed=5)
    res = {"rows": np.int64(ds.cardinality())}
    runs = {
        "full": BERT4RecEvaluator(full_ranking=True, mesh=mesh),
        "device": BERT4RecEvaluator(sampler=samplers.get("pop_random", **kw),
                                    sample_size=12, seed=3, mesh=mesh),
        "host": BERT4RecEvaluator(sampler=samplers.get("pop_random", **kw),
                                  sample_size=12, device_negatives=False,
                                  mesh=mesh)}
    for name, ev in runs.items():
        got = ev.evaluate(model, params, ds, batch_size=EVAL_BATCH[name],
                          progress_bar=False)
        res.update({f"{name}/{k}": v for k, v in got.items()})
    counts = np.bincount(source, minlength=V)
    scorer = baselines.PopularityScorer(counts, device="cpu")
    kw = dict(source=source, sample_size=12, seed=0, batch_size=5,
              mesh=mesh)
    got = mo.evaluate_scorer(scorer, None, ds, **kw)
    res.update({f"scorer/{k}": v for k, v in got.items()})
    with pytest.MonkeyPatch.context() as patch:   # the host negatives
        patch.setattr(evaluation, "BERT4RecEvaluator", functools.partial(
            evaluation.BERT4RecEvaluator, device_negatives=False))
        got = mo.evaluate_scorer(scorer, None, ds, **kw)
    res.update({f"scorer_host/{k}": v for k, v in got.items()})
    # the Recommender over this rank's pieces (every rank the same requests)
    words = [str(w) for w in inp["words"]]
    dl = BERT4RecDataloader(max_seq_len=SEQ, max_predictions_per_seq=3)
    dl.generate_vocab(words)
    n_vocab = dl.tokenizer.get_vocab_size()
    rec_model = _model(vocab_size=n_vocab, vocab_pad_to=PAD_TO)
    flat = {k[2:]: v for k, v in inp.items() if k.startswith("r/")}
    rec = Recommender(rec_model, partitioning.shard_state(
        mesh, params_from_numpy(flat, "cpu")), dl, mesh=mesh)
    top = rec.recommend_batch([words[:5], words[10:14], words[3:4]],
                              top_k=3)
    res["recommended"] = np.asarray(top)
    res["one"] = np.asarray(rec(words[:5]))
    return res


CHECKS = [f"{THIS}:{fn}" for fn in
          ("rank_loss", "rank_model", "rank_trainer", "rank_eval")]


# --------------------------------------------------------------------------- #
# the test side
# --------------------------------------------------------------------------- #

def _jax_mesh(dp, mp):
    import jax

    from bert4rec_tpu.core.mesh import MeshConfig, create_mesh
    return create_mesh(MeshConfig(model_parallelism=mp),
                       devices=jax.devices()[:dp * mp])


def _random_flat(**over):
    import jax

    from bert4rec_tpu.models import BERT4RecConfig as JaxConfig
    from bert4rec_tpu.models import BERT4RecModel as JaxModel
    from tests.test_torch_model import random_params
    jmodel = JaxModel(config=JaxConfig(**{**MODEL_KW, **over}))
    del jax
    return jmodel, random_params(jmodel, 2)


@pytest.fixture(scope="module")
def common():
    from tests import test_utils
    words = test_utils.generate_random_word_list(n_words=30, seed=0)
    jmodel, flat = _random_flat(vocab_pad_to=PAD_TO)
    jmodel_u, flat_u = _random_flat()
    from bert4rec_tpu.dataloaders import BERT4RecDataloader as JaxDL
    jdl = JaxDL(max_seq_len=SEQ, max_predictions_per_seq=3)
    jdl.generate_vocab(words)
    jrec_model, flat_r = _random_flat(
        vocab_size=jdl.tokenizer.get_vocab_size(), vocab_pad_to=PAD_TO)
    return dict(words=words, jmodel=jmodel, flat=flat, jmodel_u=jmodel_u,
                flat_u=flat_u, jdl=jdl, jrec_model=jrec_model, flat_r=flat_r)


@pytest.fixture(scope="module", params=TOPOLOGIES, ids=TOPO_IDS)
def run(request, common, tmp_path_factory):
    """One launch of the topology's ranks, every check in it."""
    dp, mp = request.param
    out = tmp_path_factory.mktemp(f"mesh_{dp}x{mp}")
    inp = write_inputs(out, common["flat"], common["flat_u"],
                       common["words"])
    extra = {f"r/{k}": v for k, v in common["flat_r"].items()}
    np.savez(out / "inputs.npz", **inp, **extra)
    records = mesh_run.launch(CHECKS, data=dp, model=mp, device="cpu",
                              out=out, timeout=600)
    world = dp * mp
    results = {c.rsplit(":", 1)[1]: mesh_run.load(out, c, world)
               for c in CHECKS}
    return dict(dp=dp, mp=mp, out=out, inp=inp, records=records,
                **results)


def _rank(run, d, m):
    return d * run["mp"] + m


def _assert_grad(got, want, name, tol=1e-5):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * scale + 1e-12, (name, err, scale)


def _whole_grad(run, results, key):
    """A gradient of the global mean: summed over 'data'; a vocab-sharded
    leaf's blocks (the table and bias of the padded model, the loss's
    table and bias) put in 'model' order."""
    dp, mp = run["dp"], run["mp"]
    per_model = [sum(results[_rank(run, d, m)][key] for d in range(dp))
                 for m in range(mp)]
    sharded = mp > 1 and (key in ("dt", "db") or key in (
        "g/encoder/item_embeddings/embedding", "g/mlm/output_bias"))
    return np.concatenate(per_model) if sharded else per_model[0]


def _jax_batch(i):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in batch(i).items()}


class TestMeshRun:

    def test_every_rank_reports_its_coordinates(self, run):
        recs = run["records"]
        assert [r["rank"] for r in recs] == list(range(run["dp"] * run["mp"]))
        for r in recs:
            assert r["coords"] == {"data": r["rank"] // run["mp"],
                                   "model": r["rank"] % run["mp"]}
            assert r["backend"] == "gloo" and r["device"] == "cpu"


class TestShardedLoss:

    def test_forward_matches_jax(self, run):
        import jax

        from bert4rec_tpu.ops.sharded_mlm_loss import sharded_fused_mlm_loss
        hidden, table, bias, labels, vocab = loss_inputs()
        mesh = _jax_mesh(run["dp"], run["mp"])
        want = jax.jit(lambda h, t, b: sharded_fused_mlm_loss(
            h, t, b, labels, vocab, mesh, True))(hidden, table, bias)
        for r in run["rank_loss"]:
            np.testing.assert_allclose(r["loss"], want[0], rtol=2e-5)
            for name, w in zip(("cv", "ca", "nv"), want[1:]):
                assert float(r[name]) == float(w), name
            rows = labels.shape[0]
            np.testing.assert_allclose(r["accuracy"], float(want[2]) / rows,
                                       rtol=1e-6)
        # unequal valid positions per 'data' slice: the global mean
        if run["dp"] == 2:
            halves = np.split(labels, 2)
            assert (halves[0] > 0).sum() != (halves[1] > 0).sum()
        assert (labels == 0).any() and (labels == 2048).any()

    def test_gradients_match_jax(self, run):
        import jax

        from bert4rec_tpu.ops.sharded_mlm_loss import sharded_fused_mlm_loss
        hidden, table, bias, labels, vocab = loss_inputs()
        mesh = _jax_mesh(run["dp"], run["mp"])
        want = jax.jit(jax.grad(lambda h, t, b: sharded_fused_mlm_loss(
            h, t, b, labels, vocab, mesh, True)[0], argnums=(0, 1, 2)))(
                hidden, table, bias)
        res, dp, mp = run["rank_loss"], run["dp"], run["mp"]
        dh = np.concatenate([res[_rank(run, d, 0)]["dh"] for d in range(dp)])
        for d in range(dp):   # dh is whole on every 'model' rank
            for m in range(mp):
                np.testing.assert_array_equal(
                    res[_rank(run, d, m)]["dh"], res[_rank(run, d, 0)]["dh"])
        _assert_grad(dh, want[0], "dh")
        _assert_grad(_whole_grad(run, res, "dt"), want[1], "dtable")
        _assert_grad(_whole_grad(run, res, "db"), want[2], "dbias")


class TestModelOnMesh:

    @pytest.fixture
    def jax_side(self, run, common):
        import jax

        from bert4rec_tpu.core.partitioning import param_shardings
        from tests.test_torch_model import to_jax
        mesh = _jax_mesh(run["dp"], run["mp"])
        params = to_jax(common["flat"])
        return mesh, jax.device_put(params, param_shardings(mesh, params))

    def test_table_is_sharded_as_jax_shards_it(self, run, jax_side):
        mesh, params = jax_side
        emb = params["encoder"]["item_embeddings"]["embedding"]
        local = emb.sharding.shard_shape(emb.shape)[0]
        for r in run["rank_model"]:
            assert int(r["table_rows"]) == local == 64 // run["mp"]

    def test_loss_metrics_and_gradients_match_jax(self, run, common,
                                                  jax_side):
        import jax
        mesh, params = jax_side
        jmodel = common["jmodel"]
        b = _jax_batch(0)

        def fn(p):
            return jmodel.loss_and_metrics(p, b, mesh=mesh)

        (loss, logs), grads = jax.jit(jax.value_and_grad(
            fn, has_aux=True))(params)
        res = run["rank_model"]
        for r in res:
            np.testing.assert_allclose(r["loss"], loss, rtol=2e-5)
            for k in ("masked_accuracy", "accuracy"):
                np.testing.assert_allclose(r[k], logs[k], rtol=1e-6)
        for k, want in flatten(grads).items():
            _assert_grad(_whole_grad(run, res, f"g/{k}"), np.asarray(want),
                         k)

    def test_scoring_and_ranking_match_jax(self, run, common, jax_side):
        import jax
        import jax.numpy as jnp
        mesh, params = jax_side
        jmodel = common["jmodel"]
        b = _jax_batch(0)
        cand = jnp.asarray(run["inp"]["candidates"])
        excl = jnp.asarray(run["inp"]["exclude"])
        scores = jax.jit(lambda p: jmodel.score_candidates(
            p, b, cand, mesh=mesh))(params)
        ids, vals = jax.jit(lambda p: jmodel.rank_top_k(
            p, b, K, mesh=mesh, exclude=excl))(params)
        _, probs = jax.jit(lambda p: jmodel.rank_top_k(
            p, b, K, mesh=mesh, exclude=excl, with_probabilities=True))(
                params)
        ranks = jax.jit(lambda p: jmodel.gt_ranks_full_vocab(
            p, b, exclude=excl))(params)
        logits = jax.jit(lambda p: jmodel.apply(p, b)["mlm_logits"])(params)
        res, dp = run["rank_model"], run["dp"]
        for m in range(run["mp"]):
            got = {k: np.concatenate([res[_rank(run, d, m)][k]
                                      for d in range(dp)])
                   for k in ("scores", "top_ids", "top_vals", "prob_ids",
                             "probs", "full_ranks", "logits")}
            np.testing.assert_allclose(got["scores"], scores, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_array_equal(got["top_ids"], ids)
            np.testing.assert_array_equal(got["prob_ids"], ids)
            np.testing.assert_allclose(got["top_vals"], vals, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got["probs"], probs, rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_array_equal(got["full_ranks"], ranks)
            np.testing.assert_allclose(got["logits"], logits, rtol=1e-5,
                                       atol=1e-4)
        for i in range(ids.shape[0]):   # each row's exclusions hold
            assert not np.isin(np.asarray(ids[i]), np.asarray(excl[i])).any()

    def test_unsharded_vocab_takes_global_means(self, run, common):
        """61 rows on 2 'model' ranks: replicated (JAX's warning), the
        unsharded loss, its means over the global batch."""
        import jax

        from bert4rec_tpu.core.partitioning import param_shardings
        from tests.test_torch_model import to_jax
        mesh = _jax_mesh(run["dp"], run["mp"])
        params = to_jax(common["flat_u"])
        if run["mp"] > 1:
            with pytest.warns(UserWarning, match="replicating"):
                shardings = param_shardings(mesh, params)
        else:
            shardings = param_shardings(mesh, params)
        params = jax.device_put(params, shardings)
        b = _jax_batch(0)
        (loss, logs), grads = jax.jit(jax.value_and_grad(
            lambda p: common["jmodel_u"].loss_and_metrics(p, b, mesh=mesh),
            has_aux=True))(params)
        res = run["rank_model"]
        for r in res:
            np.testing.assert_allclose(r["u_loss"], loss, rtol=2e-5)
            for k in ("masked_accuracy", "accuracy"):
                np.testing.assert_allclose(r[f"u_{k}"], logs[k], rtol=1e-6)
        for k, want in flatten(grads).items():
            _assert_grad(_whole_grad(run, res, f"u_g/{k}"),
                         np.asarray(want), k)


class TestTrainerOnMesh:

    def test_steps_match_jax_and_one_process(self, run, common):
        """Two clipped AdamW steps on unequal slices: the global-mean loss,
        the 'data'-summed gradients and the global clip norm give JAX's
        trainer's losses and params, and the port's one-process run's."""
        import jax

        from bert4rec_tpu.trainers import BERT4RecTrainer as JaxTrainer
        from bert4rec_tpu.trainers import optimizers as jax_opt
        from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
        from tests.test_torch_model import to_jax
        mesh = _jax_mesh(run["dp"], run["mp"])
        jt = JaxTrainer(common["jmodel"], mesh=mesh)
        jt.initialize_model(
            optimizer=jax_opt.create_adam_w_optimizer(**OPT),
            params=to_jax(common["flat"]), rng=jax.random.key(3))
        one = BERT4RecTrainer(_model(vocab_pad_to=PAD_TO))
        one.initialize_model(optimizer=optimizers.create_adam_w_optimizer(
            **OPT), params=params_from_numpy(common["flat"], "cpu"),
            seed=3, device="cpu")
        jlogs, ologs = [], []
        for i in range(2):
            jt.state, logs = jt._train_step_fn(jt.state,
                                               jt._put_batch(batch(i)))
            jlogs.append(float(logs["loss"]))
            ologs.append(float(one.train_step(one._put_batch(batch(i)))
                               ["loss"]))
        jparams = {k: np.asarray(v)
                   for k, v in flatten(jt.state["params"]).items()}
        for r in run["rank_trainer"]:
            got = [float(r[f"step{i}/loss"]) for i in range(2)]
            np.testing.assert_allclose(got, jlogs, rtol=1e-5)
            np.testing.assert_allclose(got, ologs, rtol=1e-5)
            assert float(r["step0/_n_valid"]) == \
                float((batch(0)["masked_lm_weights"] > 0).sum())
            for k, v in jparams.items():
                np.testing.assert_allclose(r[f"p/{k}"], v, rtol=0,
                                           atol=2e-5, err_msg=k)
                np.testing.assert_allclose(
                    r[f"p/{k}"], flatten(one.params)[k].detach().numpy(),
                    rtol=0, atol=2e-5, err_msg=k)
        moved = max(np.abs(jparams[k] - common["flat"][k]).max()
                    for k in jparams)
        assert moved > 1e-3

    def test_clip_is_active(self, run):
        """The first step's global gradient norm (the sharded leaves'
        squares over 'model', the rest once) is over the clip bound."""
        res = run["rank_model"]
        keys = [k for k in res[0] if k.startswith("g/")]
        sq = sum(float((_whole_grad(run, res, k) ** 2).sum()) for k in keys)
        assert np.sqrt(sq) > 2 * OPT["global_clipnorm"]

    def test_checkpoint_loads_in_jax_and_one_process(self, run, common):
        """The sharded run's checkpoint holds the whole tables in the JAX
        trainer's layout: JAX's unmodified load_checkpoint restores it, and
        so does a one-process port trainer, to the gathered params."""
        import jax

        from bert4rec_tpu.trainers import BERT4RecTrainer as JaxTrainer
        from bert4rec_tpu.trainers import optimizers as jax_opt
        from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
        from tests.test_torch_model import to_jax
        path = run["out"] / "ckpt.npz"
        jt = JaxTrainer(common["jmodel"])
        jt.initialize_model(optimizer=jax_opt.create_adam_w_optimizer(**OPT),
                            params=to_jax(common["flat"]),
                            rng=jax.random.key(0))
        jt.load_checkpoint(str(path))
        one = BERT4RecTrainer(_model(vocab_pad_to=PAD_TO))
        one.initialize_model(optimizer=optimizers.create_adam_w_optimizer(
            **OPT), params=params_from_numpy(common["flat"], "cpu"),
            device="cpu")
        one.load_checkpoint(path)
        gathered = run["rank_trainer"][0]
        assert int(jt.state["step"]) == one.state["step"] == 2
        for k, v in flatten(jt.state["params"]).items():
            np.testing.assert_array_equal(np.asarray(v), gathered[f"p/{k}"])
            np.testing.assert_array_equal(
                flatten(one.params)[k].detach().numpy(), gathered[f"p/{k}"])

    def test_data_ranks_draw_their_own_dropout(self, run):
        res = run["rank_trainer"]
        for d in range(run["dp"]):
            base = res[_rank(run, d, 0)]
            assert abs(base["keep"].mean() - 0.7) < 0.02
            for m in range(run["mp"]):
                np.testing.assert_array_equal(res[_rank(run, d, m)]["keep"],
                                              base["keep"])
        if run["dp"] > 1:
            a, b = res[_rank(run, 0, 0)], res[_rank(run, 1, 0)]
            assert a["step_seed"] != b["step_seed"]
            assert (a["keep"] != b["keep"]).mean() > 0.3


class TestEvaluationOnMesh:

    def _jax_params(self, run, common, key="flat"):
        import jax

        from bert4rec_tpu.core.partitioning import param_shardings
        from tests.test_torch_model import to_jax
        mesh = _jax_mesh(run["dp"], run["mp"])
        params = to_jax(common[key])
        return mesh, jax.device_put(params, param_shardings(mesh, params))

    def _jax_ds(self):
        from bert4rec_tpu.dataloaders.processed_dataset import (
            MaskingConfig, ProcessedDataset,
        )
        seqs = eval_sequences()
        return ProcessedDataset(seqs, MaskingConfig(**MASK_KW), lambda: V,
                                finetuning=np.full(len(seqs), True),
                                task="mlm")

    @staticmethod
    def _port_ds():
        """The port's one-process dataset and the sampler's source."""
        from bert4rec_tpu_torch.dataloaders.processed_dataset import (
            MaskingConfig, ProcessedDataset,
        )
        seqs = eval_sequences()
        ds = ProcessedDataset(seqs, MaskingConfig(**MASK_KW), lambda: V,
                              finetuning=np.full(len(seqs), True),
                              task="mlm")
        return ds, [int(t) for s in seqs for t in s]

    @staticmethod
    def _metrics(r, name):
        return {k.split("/", 1)[1]: float(v) for k, v in r.items()
                if k.startswith(name + "/")}

    def test_slices_follow_the_data_axis(self, run):
        for r in run["rank_eval"]:
            assert int(r["rows"]) == N_EVAL // run["dp"]

    def test_full_ranking_matches_jax(self, run, common):
        from bert4rec_tpu.evaluation import BERT4RecEvaluator as JaxEvaluator
        mesh, params = self._jax_params(run, common)
        want = JaxEvaluator(full_ranking=True, mesh=mesh).evaluate(
            common["jmodel"], params, self._jax_ds(), batch_size=8,
            progress_bar=False)
        for r in run["rank_eval"]:
            got = self._metrics(r, "full")
            assert got["Valid Ranks"] == want["Valid Ranks"] == N_EVAL
            for k, v in want.items():
                assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-12), k

    def test_sampled_protocols(self, run, common):
        """Host negatives: JAX's metrics where one 'data' rank draws the
        global batch's negatives; device negatives: the port's one-process
        metrics there. With several 'data' ranks each draws its own, so
        the counts agree and the metrics are the same on every rank."""
        from bert4rec_tpu.dataloaders import samplers as jax_samplers
        from bert4rec_tpu.evaluation import BERT4RecEvaluator as JaxEvaluator
        from bert4rec_tpu_torch.dataloaders import samplers
        from bert4rec_tpu_torch.evaluation import BERT4RecEvaluator
        ds, source = self._port_ds()
        ev = BERT4RecEvaluator(sampler=samplers.get(
            "pop_random", source=source, vocab=list(dict.fromkeys(source)),
            sample_size=12, seed=5), sample_size=12, seed=3)
        one = ev.evaluate(_model(vocab_pad_to=PAD_TO), params_from_numpy(
            common["flat"], "cpu"), ds, batch_size=EVAL_BATCH["device"],
            progress_bar=False)
        res = run["rank_eval"]
        for name in ("host", "device"):
            first = self._metrics(res[0], name)
            assert first["Valid Ranks"] == N_EVAL
            for r in res[1:]:
                assert self._metrics(r, name) == first
        if run["dp"] == 1:
            mesh, params = self._jax_params(run, common)
            seqs = eval_sequences()
            source = [int(t) for s in seqs for t in s]
            want_host = JaxEvaluator(
                sampler=jax_samplers.get("pop_random", source=source,
                                         vocab=list(dict.fromkeys(source)),
                                         sample_size=12, seed=5),
                sample_size=12, device_negatives=False, mesh=mesh).evaluate(
                    common["jmodel"], params, self._jax_ds(),
                    batch_size=EVAL_BATCH["host"], progress_bar=False)
            assert self._metrics(res[0], "host") == pytest.approx(want_host)
            assert self._metrics(res[0], "device") == pytest.approx(one)

    def test_evaluate_scorer(self, run):
        """``evaluate_scorer(mesh=)``: on one 'data' rank the port's
        one-process metrics (device negatives) and JAX's mesh path's (host
        negatives, the same draws); with several, the counts, and one
        answer on every rank."""
        import functools

        from bert4rec_tpu import evaluation as jax_evaluation
        from bert4rec_tpu.evaluation import baselines as jax_baselines
        from bert4rec_tpu.evaluation import markov_oracle as jax_mo
        from bert4rec_tpu_torch.evaluation import baselines
        from bert4rec_tpu_torch.evaluation import markov_oracle as mo
        ds, source = self._port_ds()
        counts = np.bincount(source, minlength=V)
        kw = dict(source=source, sample_size=12, seed=0, batch_size=5)
        one = mo.evaluate_scorer(
            baselines.PopularityScorer(counts, device="cpu"), None, ds, **kw)
        res = run["rank_eval"]
        for name in ("scorer", "scorer_host"):
            for r in res:
                got = self._metrics(r, name)
                assert got["Valid Ranks"] == one["Valid Ranks"] == N_EVAL
                assert got == self._metrics(res[0], name)
        if run["dp"] == 1:
            assert self._metrics(res[0], "scorer") == pytest.approx(one)
            with pytest.MonkeyPatch.context() as patch:
                patch.setattr(jax_evaluation, "BERT4RecEvaluator",
                              functools.partial(
                                  jax_evaluation.BERT4RecEvaluator,
                                  device_negatives=False))
                want = jax_mo.evaluate_scorer(
                    jax_baselines.PopularityScorer(counts),
                    None, self._jax_ds(), mesh=_jax_mesh(1, run["mp"]),
                    **kw)
            assert self._metrics(res[0], "scorer_host") == pytest.approx(
                {k: float(v) for k, v in want.items()})

    def test_recommender_matches_jax(self, run, common):
        import jax

        from bert4rec_tpu.apps import Recommender as JaxRecommender
        from bert4rec_tpu.core.partitioning import param_shardings
        from tests.test_torch_model import to_jax
        mesh = _jax_mesh(run["dp"], run["mp"])
        params = to_jax(common["flat_r"])
        params = jax.device_put(params, param_shardings(mesh, params))
        words = common["words"]
        rec = JaxRecommender(common["jrec_model"], params, common["jdl"],
                             mesh=mesh)
        want = rec.recommend_batch([words[:5], words[10:14], words[3:4]],
                                   top_k=3)
        for r in run["rank_eval"]:
            assert r["recommended"].tolist() == want
            assert str(r["one"]) == rec(words[:5])
