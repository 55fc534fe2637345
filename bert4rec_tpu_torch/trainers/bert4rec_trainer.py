"""BERT4Rec trainer: the train step and an explicit epoch loop (port of
``bert4rec_tpu/trainers/bert4rec_trainer.py``).

- train step = gradient of the model's masked-SCCE loss (the fused loss
  kernels where the config routes there) -> clip + AdamW
  (``trainers/optimizers``), params and moments updated in place;
- metrics ``masked_accuracy`` and ``accuracy`` on the device, weighted into
  exact epoch means by their position counts;
- best-metric checkpointing and exact resume: the train state is the
  params, the optimizer state, ``step``, ``seed``, ``epoch`` and
  ``best_monitor``, saved in the JAX trainer's layout (either package
  resumes the other's file), and every dropout seed of a step is
  ``fold_in(seed, step)`` (``fold_in(that, i)`` for microbatch ``i`` under
  gradient accumulation), so a resumed run draws the same masks;
- ``steps_per_call`` runs K optimizer steps per call as a plain loop (the
  JAX ``lax.scan``; the same math), ``grad_accum_steps`` folds A
  microbatches into one update weighted by their valid positions, and
  ``validate()`` runs one eval step per batch whatever
  ``eval_steps_per_call`` (JAX's stacked eval dispatch; the same math).

- ``train()`` and ``validate()`` feed their batches through
  ``utils.prefetch``: a host thread slices and masks batch k+1 and copies
  it to the card (pinned memory, a side stream) while step k runs.
- spans (``utils.profiling.span``, recorded under ``record_spans()`` and
  in ``train(profile_dir=...)``'s trace): ``trainer.step`` around each
  train step, inside it ``trainer.forward``, ``trainer.backward``,
  ``trainer.optimizer`` and ``trainer.sync`` (a call that blocks the host
  until the card has caught up); ``trainer.epoch_end`` from the end of an
  epoch's batches to the end of its callbacks; ``pipeline.wait`` (in
  ``utils.prefetch``) where the loop waits for its next batch.

On a ``(data, model)`` mesh (``core/mesh.py``, one process per rank) the
train state is this rank's pieces (``core/partitioning.py``: the item
table, the output bias and their moments row-sharded over 'model'), each
batch is this rank's 'data' slice (every rank of one 'data' coordinate
gets the same one: ``ProcessedDataset.shard_for_process(mesh=...)``), the
loss and metrics are the global batch's (``model.loss_and_metrics(mesh=
...)``), every gradient is summed over 'data' in one all_reduce, the clip's
norm adds the sharded leaves' squares over 'model' and the replicated ones
once, and each 'data' coordinate draws its own dropout stream (the
coordinate folded into the step seed when the axis has several). A
checkpoint holds the whole tables in the JAX trainer's layout, written by
rank 0; loading it into a mesh cuts each rank's pieces.
"""

import contextlib
import itertools
import time
from typing import Optional

import numpy as np
import torch

from bert4rec_tpu_torch.core import mesh as mesh_lib
from bert4rec_tpu_torch.core import partitioning
from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS
from bert4rec_tpu_torch.ops.dropout_bits import fold_in
from bert4rec_tpu_torch.trainers import optimizers, trainer_utils
from bert4rec_tpu_torch.trainers.base_trainer import BaseTrainer
from bert4rec_tpu_torch.trainers.callbacks import History, ModelCheckpoint
from bert4rec_tpu_torch.utils import checkpoint as ckpt_lib
from bert4rec_tpu_torch.utils import prefetch as prefetch_lib
from bert4rec_tpu_torch.utils import profiling

_BATCH_KEYS = ("input_word_ids", "input_mask", "masked_lm_positions",
               "masked_lm_ids")
# carried when the batch has them (the temporal preprocessor's timestamps)
_OPTIONAL_KEYS = ("input_timestamps",)


class BERT4RecTrainer(BaseTrainer):

    def __init__(self, model, mesh=None, steps_per_call: int = 1,
                 grad_accum_steps: int = 1, eval_steps_per_call: int = 1):
        """JAX's signature. ``mesh``: this rank's ``core.mesh.Mesh``
        (``core.create_mesh``); anything else raises a TypeError.
        ``steps_per_call``: optimizer steps per call of the step function
        over a group of K batches (identical math to single steps; logs
        come back per step). ``grad_accum_steps``: A microbatches per
        optimizer update, their gradients combined weighted by each one's
        count of valid MLM positions, so the update equals that of one
        A-times-larger batch; trailing batches that do not fill a group
        are dropped. The two are mutually exclusive.
        ``eval_steps_per_call``: JAX's stacked eval dispatch of K batches;
        ``validate()`` runs the same math as a plain loop of one eval step
        per batch, whatever K."""
        super().__init__(model)
        self.mesh = mesh_lib.as_mesh(mesh, "BERT4RecTrainer")
        self.eval_steps_per_call = max(1, int(eval_steps_per_call))
        self.steps_per_call = max(1, int(steps_per_call))
        self.grad_accum_steps = max(1, int(grad_accum_steps))
        if self.steps_per_call > 1 and self.grad_accum_steps > 1:
            raise ValueError(
                "steps_per_call and grad_accum_steps are mutually exclusive "
                "dispatch modes: the first runs K optimizer steps per call, "
                "the second folds A microbatches into one optimizer step — "
                f"pick one (got steps_per_call={self.steps_per_call}, "
                f"grad_accum_steps={self.grad_accum_steps})")
        self.state = None   # {"params", "opt_state", "step", "seed"}
        self.device = None
        self._put = None     # host batch -> device tensors (prefetch's put)
        self._epochs_completed = None
        self._best_monitor_value = None
        self._custom_loss = False
        self._sharded_paths = frozenset()

    # ------------------------------------------------------------------ #
    # setup
    # ------------------------------------------------------------------ #

    def initialize_model(self, optimizer=None, loss=None,
                         metrics: Optional[dict] = None,
                         params: Optional[dict] = None, seed: int = 0,
                         device="cuda") -> None:
        """Build the optimizer/loss/metric defaults and the train state.
        ``params`` (a nested dict of tensors) is moved to ``device``;
        without it the model is initialised from ``seed``. A custom
        ``loss`` or ``metrics`` routes the step through the logits path.
        On a mesh the state lives on the mesh's device, cut to this rank's
        pieces (the whole ``params``, the same on every rank, go in)."""
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self._put = prefetch_lib.device_put(self.device, _BATCH_KEYS,
                                            _OPTIONAL_KEYS)
        self.optimizer = optimizers.get(optimizer if optimizer is not None
                                        else "adamw")
        self._custom_loss = loss is not None or metrics is not None
        self.loss = loss or trainer_utils.masked_sparse_categorical_crossentropy
        self.metrics = metrics if metrics is not None else {
            "masked_accuracy": trainer_utils.masked_accuracy,
            "accuracy": trainer_utils.sparse_categorical_accuracy,
        }
        if params is None:
            params = self.model.init(torch.Generator().manual_seed(seed),
                                     self.device)
        params = ckpt_lib.unflatten({
            k: v.detach().to(self.device, torch.float32).clone()
            .requires_grad_(True)
            for k, v in ckpt_lib.flatten(params).items()})
        if self.mesh is not None:
            params = partitioning.shard_state(self.mesh, params)
            self._sharded_paths = frozenset(
                k for k, v in ckpt_lib.flatten(params).items()
                if partitioning.spec_for_path(k, v)
                and partitioning.vocab_sharded(self.mesh, v.shape[0],
                                               self._vocab_rows))
        self.state = {"params": params,
                      "opt_state": self.optimizer.init(params),
                      "step": 0, "seed": int(seed)}

    # ------------------------------------------------------------------ #
    # steps
    # ------------------------------------------------------------------ #

    @property
    def _vocab_rows(self) -> int:
        """The whole item table's rows (what a sharded leaf gathers to)."""
        config = getattr(self.model, "config", None)
        return getattr(config, "padded_vocab_size", 0)

    def _put_batch(self, batch: dict) -> dict:
        """Host numpy batch -> the tensors the step reads, on the device
        (pinned staging and a side-stream copy on the card); on a mesh
        the batch is this rank's 'data' slice (``place_batch``'s check)."""
        if self.mesh is not None:
            partitioning.check_batch(self.mesh, batch)
        return self._put(batch)

    def _prefetched(self, raw):
        """``raw`` host batches placed on the device by a prefetch thread,
        two ahead of the step; closed when the caller leaves early."""
        return contextlib.closing(
            prefetch_lib.prefetch(raw, self._put_batch, depth=2))

    def _loss_and_logs(self, params, batch, training, seed):
        mesh = {"mesh": self.mesh} if self.mesh is not None else {}
        if not self._custom_loss and hasattr(self.model, "loss_and_metrics"):
            return self.model.loss_and_metrics(params, batch,
                                               training=training, seed=seed,
                                               **mesh)
        logits = self.model.apply(params, batch, training=training,
                                  seed=seed, **mesh)["mlm_logits"]
        labels = batch["masked_lm_ids"]
        # a custom loss is a mean over the slice's valid positions
        return trainer_utils.global_means(
            self.mesh, self.loss(labels, logits),
            {name: metric(labels, logits)
             for name, metric in self.metrics.items()}, labels)

    def _counts(self, batch) -> dict:
        """The batch's position counts (the global batch's on a mesh)."""
        labels = batch["masked_lm_ids"]
        n_valid = trainer_utils.n_valid_positions(labels)
        # a copy from the host: on the card it waits for the stream
        with profiling.span("trainer.sync"):
            n_total = torch.tensor(float(labels.numel()), device=labels.device)
        counts = torch.stack([n_valid, n_total,
                              trainer_utils.n_real_positions(labels)])
        if self.mesh is not None:
            counts = mesh_lib.all_reduce(self.mesh, counts, DATA_AXIS)
        return dict(zip(("_n_valid", "_n_total", "_n_real"), counts))

    def _step_seed(self) -> int:
        """``fold_in(seed, step)``; with several 'data' coordinates, this
        rank's coordinate folded in (its own dropout stream)."""
        seed = fold_in(self.state["seed"], self.state["step"])
        if self.mesh is not None and self.mesh.size(DATA_AXIS) > 1:
            seed = fold_in(seed, self.mesh.index(DATA_AXIS))
        return seed

    def _grads(self, batch, seed=None):
        """(loss, logs, {path: grad}) of one batch at the current params,
        dropout from ``seed`` (None: the step's, ``_step_seed``); a param
        the loss does not reach (the pooler) gets a zero grad."""
        with profiling.span("trainer.forward"):
            if seed is None:
                seed = self._step_seed()
            loss, logs = self._loss_and_logs(self.state["params"], batch,
                                             True, seed)
        with profiling.span("trainer.backward"):
            flat = ckpt_lib.flatten(self.state["params"])
            grads = torch.autograd.grad(loss, list(flat.values()),
                                        allow_unused=True)
            return loss.detach(), {k: v.detach() for k, v in logs.items()}, {
                k: (torch.zeros_like(p) if g is None else g)
                for (k, p), g in zip(flat.items(), grads)}

    def _apply(self, grads) -> None:
        sq_norm = None
        if self.mesh is not None:
            grads = self._sum_over_data(grads)
            if self._sharded_paths:
                sq_norm = self._global_sq_norm
        with profiling.span("trainer.optimizer"):
            self.state["opt_state"] = self.optimizer.update(
                grads, self.state["opt_state"], self.state["params"],
                sq_norm=sq_norm)
        self.state["step"] += 1

    def _sum_over_data(self, grads: dict) -> dict:
        """Every gradient summed over 'data', one all_reduce of a flat
        buffer (each rank's gradient is its slice's share of the global
        mean's)."""
        if self.mesh.size(DATA_AXIS) == 1:
            return grads
        keys = list(grads)
        flat = torch.cat([grads[k].float().reshape(-1) for k in keys])
        mesh_lib.all_reduce(self.mesh, flat, DATA_AXIS)
        out, i = {}, 0
        for k in keys:
            n = grads[k].numel()
            out[k] = flat[i:i + n].view_as(grads[k]).to(grads[k].dtype)
            i += n
        return out

    def _global_sq_norm(self, sums: dict) -> torch.Tensor:
        """The clip's squared norm: the sharded leaves' sums of squares
        added over 'model', the replicated leaves' counted once."""
        sharded = [v for k, v in sums.items() if k in self._sharded_paths]
        rest = [v for k, v in sums.items() if k not in self._sharded_paths]
        total = mesh_lib.all_reduce(self.mesh, torch.stack(sharded).sum(),
                                    MODEL_AXIS)
        return torch.stack(rest).sum() + total

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on a device batch; returns its logs."""
        with profiling.span("trainer.step"):
            loss, logs, grads = self._grads(batch)
            self._apply(grads)
            return {"loss": loss, **logs, **self._counts(batch)}

    def accum_step(self, batches: list) -> dict:
        """One optimizer step from ``len(batches)`` microbatches: the
        gradient is ``sum(n_valid_a * g_a) / sum(n_valid_a)``, what one
        big batch's valid-position mean gives. Logs are stacked per
        microbatch."""
        with profiling.span("trainer.step"):
            step_seed = self._step_seed()
            gsum, wsum, logs = None, 0.0, []
            for idx, batch in enumerate(batches):
                loss, blogs, grads = self._grads(batch,
                                                 fold_in(step_seed, idx))
                counts = self._counts(batch)
                w = counts["_n_valid"]
                if gsum is None:
                    gsum = {k: w * g for k, g in grads.items()}
                else:
                    for k, g in grads.items():
                        gsum[k] = gsum[k] + w * g
                wsum = wsum + w
                logs.append({"loss": loss, **blogs, **counts})
            denom = torch.clamp(wsum, min=1.0)
            self._apply({k: g / denom for k, g in gsum.items()})
            return {k: torch.stack([lg[k] for lg in logs]) for k in logs[0]}

    def eval_step(self, batch: dict) -> dict:
        with torch.no_grad():
            loss, logs = self._loss_and_logs(self.state["params"], batch,
                                             False, None)
        return {"loss": loss, **logs, **self._counts(batch)}

    # ------------------------------------------------------------------ #
    # train / validate
    # ------------------------------------------------------------------ #

    @staticmethod
    def _accumulate(sums: dict, wsums: dict, logs: dict) -> None:
        """Weight per-batch means by their position counts so the epoch
        mean is the exact mean over positions: masked metrics by valid
        positions, the unmasked ``accuracy``'s hits over all positions by
        real-row positions."""
        w_valid = logs.pop("_n_valid")
        w_total = logs.pop("_n_total")
        w_real = logs.pop("_n_real")
        for k, v in logs.items():
            if k == "accuracy":
                sums[k] = sums.get(k, 0.0) + torch.sum(v * w_total)
                wsums[k] = wsums.get(k, 0.0) + torch.sum(w_real)
            else:
                sums[k] = sums.get(k, 0.0) + torch.sum(v * w_valid)
                wsums[k] = wsums.get(k, 0.0) + torch.sum(w_valid)

    @staticmethod
    def _means(sums: dict, wsums: dict) -> dict:
        return {k: float(v) / max(float(wsums[k]), 1.0)
                for k, v in sums.items()}

    def train(self, train_ds, val_ds=None, checkpoint_path=None,
              epochs: int = 50, batch_size: int = 256,
              steps_per_epoch: Optional[int] = None,
              validation_steps: Optional[int] = None, seed: int = 42,
              verbose: bool = True, profile_dir: Optional[str] = None,
              profile_steps: int = 5) -> History:
        """Epoch loop over a dataset with the JAX ``batches(batch_size,
        shuffle=, seed=, drop_remainder=, pad_final_batch=)`` contract
        yielding numpy dicts (fresh masks per epoch, shuffled with
        ``seed + epoch``), with best-checkpointing and auto-resume from
        ``checkpoint_path``. Without a train state it initialises one on
        the card from ``seed``. With ``profile_dir``, optimizer steps [1,
        1 + ``profile_steps``) of this call (step 0 builds the kernels) are
        traced into it (``utils.profiling.trace``), as JAX's
        ``jax.profiler`` capture."""
        if self.state is None:
            self.initialize_model(seed=seed)
        history = History()
        callbacks = [history] + list(self.callbacks)
        start_epoch = 0
        if checkpoint_path is not None:
            callbacks.append(ModelCheckpoint(checkpoint_path,
                                             verbose=verbose))
            try:
                self.load_checkpoint(checkpoint_path)
                if self._epochs_completed is not None:
                    start_epoch = min(self._epochs_completed, epochs)
                if verbose:
                    print(f"[resume] restored train state from "
                          f"{checkpoint_path} at step {self.state['step']} "
                          f"(continuing at epoch {start_epoch + 1})")
            except FileNotFoundError:
                pass

        for cb in callbacks:
            cb.on_train_begin(self)

        accum = self.grad_accum_steps > 1
        group_k = self.grad_accum_steps if accum else self.steps_per_call
        # profiling.trace of this call's optimizer steps [1, 1 +
        # profile_steps), counted on the train state (JAX's capture)
        profiler = contextlib.ExitStack()
        step0 = self.state["step"]

        def before_step():
            if profile_dir is None:
                return
            if self.state["step"] - step0 == 1:
                profiler.enter_context(profiling.trace(profile_dir))
            elif self.state["step"] - step0 == 1 + profile_steps:
                profiler.close()

        with profiler:
            for epoch in range(start_epoch, epochs):
                t0 = time.time()
                sums, wsums = {}, {}
                count = n_examples = 0
                raw = train_ds.batches(batch_size, shuffle=True,
                                       seed=seed + epoch,
                                       drop_remainder=True)
                if steps_per_epoch:
                    raw = itertools.islice(
                        raw, steps_per_epoch * (group_k if accum else 1))
                with self._prefetched(raw) as placed:
                    while True:
                        group = list(itertools.islice(placed, group_k))
                        if not group:
                            break
                        if accum:
                            if len(group) < group_k:
                                break   # a partial group changes the batch
                            before_step()
                            self._accumulate(sums, wsums,
                                             self.accum_step(group))
                            count += 1
                            n_examples += sum(len(b["input_word_ids"])
                                              for b in group)
                        else:
                            for b in group:
                                before_step()
                                self._accumulate(sums, wsums,
                                                 self.train_step(b))
                                count += 1
                                n_examples += len(b["input_word_ids"])
                                if steps_per_epoch \
                                        and count >= steps_per_epoch:
                                    break
                        if steps_per_epoch and count >= steps_per_epoch:
                            break
                with profiling.span("trainer.epoch_end"):
                    logs = self._means(sums, wsums)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    logs["examples_per_second"] = n_examples / max(
                        time.time() - t0, 1e-9)

                    if val_ds is not None:
                        val_logs = self.validate(
                            val_ds, batch_size=batch_size,
                            validation_steps=validation_steps,
                            seed=seed + epoch)
                        logs.update({f"val_{k}": v
                                     for k, v in val_logs.items()})
                    if verbose:
                        msg = " ".join(f"{k}={v:.4f}"
                                       for k, v in sorted(logs.items()))
                        print(f"epoch {epoch + 1}/{epochs}: {msg}")
                    self._epochs_completed = epoch + 1
                    stop = False
                    for cb in callbacks:
                        cb.on_epoch_end(self, epoch, logs)
                        stop = stop or cb.stop_training
                if stop:
                    break
        for cb in callbacks:
            cb.on_train_end(self)
        return history

    def validate(self, val_ds, batch_size: int = 256,
                 validation_steps: Optional[int] = None,
                 seed: int = 0) -> dict:
        """Weighted metrics over the validation set (the final batch is
        zero-padded; its fake rows carry no weight)."""
        sums, wsums = {}, {}
        raw = val_ds.batches(batch_size, shuffle=False, seed=seed,
                             pad_final_batch=True)
        if validation_steps:
            raw = itertools.islice(raw, validation_steps)
        with self._prefetched(raw) as placed:
            for batch in placed:
                self._accumulate(sums, wsums, self.eval_step(batch))
        return self._means(sums, wsums)

    # ------------------------------------------------------------------ #
    # persistence
    # ------------------------------------------------------------------ #

    def save_checkpoint(self, path) -> None:
        """The train state in the JAX trainer's layout, so JAX's own
        ``load_checkpoint`` restores it: ``params/...``, optax's
        ``opt_state/1/0/{count,mu,nu}`` and ``opt_state/1/2/count``
        (``optimizers.optax_paths``), ``step`` int32 and ``rng`` as JAX
        computes it from the seed (``checkpoint.rng_key_data``); beside
        them the port's whole ``seed`` (JAX's key keeps its low 32 bits
        only; JAX's load reads by its own keys and ignores it), ``epoch``
        and ``best_monitor``. On a mesh every rank must call it: the
        sharded leaves are gathered whole and rank 0 writes."""
        best = self._best_monitor_value
        tree = {"params": self.state["params"],
                **optimizers.optax_paths(self.state["opt_state"]),
                "step": np.int32(self.state["step"]),
                "rng": ckpt_lib.rng_key_data(self.state["seed"]),
                "seed": np.int64(self.state["seed"]),
                "epoch": np.int32(self._epochs_completed or 0),
                "best_monitor": np.float64(best if best is not None
                                           else np.nan)}
        ckpt_lib.save_pytree(path, tree, mesh=self.mesh,
                             vocab_rows=self._vocab_rows)

    def load_checkpoint(self, path) -> None:
        """The train state from ``path``, in the JAX trainer's layout
        (either package's file) or in the port's earlier one
        (``opt_state/{count,mu,nu}``, ``seed``, no ``rng``). A file with a
        ``seed`` resumes that seed; a JAX file's ``rng`` gives ``hi << 32 |
        lo``. ``epoch`` and ``best_monitor`` are optional records, absent
        in legacy checkpoints (as in JAX). On a mesh each rank cuts its
        pieces from the whole leaves."""
        if self.state is None:
            raise RuntimeError("Call initialize_model before load_checkpoint")
        stored = ckpt_lib.load_npz(path)
        if self.mesh is not None:
            stored = partitioning.shard_flat(self.mesh, stored)
        source = f"Checkpoint {path}"
        if f"{optimizers.ADAM_PATH}/count" in stored:
            opt_prefix = optimizers.ADAM_PATH + "/"
            count = optimizers.optax_count(stored, source)
        elif "opt_state/count" in stored:     # the port's earlier layout
            opt_prefix = "opt_state/"
            count = int(stored["opt_state/count"])
        else:
            raise KeyError(f"{source} is missing leaf "
                           f"{optimizers.ADAM_PATH + '/count'!r}; it has "
                           f"{sorted(stored)[:8]}...")
        if "seed" in stored:
            seed = int(stored["seed"])
            if "rng" in stored and not np.array_equal(
                    stored["rng"], ckpt_lib.rng_key_data(seed)):
                raise ValueError(f"{source} holds seed {seed} and an rng "
                                 f"{stored['rng']} that is not its key")
        elif "rng" in stored:
            seed = ckpt_lib.seed_from_key_data(stored["rng"])
        else:
            raise KeyError(f"{source} is missing leaf 'rng'")
        params = self._restore(stored, "params/", self.state["params"],
                               source, requires_grad=True)
        mu, nu = (self._restore(stored, f"{opt_prefix}{name}/",
                                self.state["opt_state"][name], source)
                  for name in ("mu", "nu"))
        self.state = {"params": params,
                      "opt_state": {"count": count, "mu": mu, "nu": nu},
                      "step": int(stored["step"]), "seed": seed}
        self._epochs_completed = self._best_monitor_value = None
        if "epoch" in stored:
            self._epochs_completed = int(stored["epoch"]) or None
        if "best_monitor" in stored and np.isfinite(stored["best_monitor"]):
            self._best_monitor_value = float(stored["best_monitor"])

    @staticmethod
    def _restore(stored: dict, prefix: str, like: dict, source: str,
                 requires_grad: bool = False) -> dict:
        """``like``'s tree of tensors from ``stored[prefix + path]``, with
        the stored values and dtype on each leaf's device."""
        flat = {k[len(prefix):]: v for k, v in stored.items()
                if k.startswith(prefix)}
        ckpt_lib.check_structure(flat, like, source)
        return ckpt_lib.unflatten({
            k: torch.from_numpy(np.array(flat[k], copy=True)).to(t.device)
            .requires_grad_(requires_grad)
            for k, t in ckpt_lib.flatten(like).items()})

    @property
    def params(self):
        """The params this rank holds (its pieces on a mesh)."""
        return self.state["params"] if self.state is not None else None

    def gathered_params(self) -> dict:
        """The whole params on every rank (on a mesh a collective: every
        rank must call it)."""
        if self.mesh is None:
            return self.params
        return partitioning.gather_state(self.mesh, self.params,
                                         self._vocab_rows)
