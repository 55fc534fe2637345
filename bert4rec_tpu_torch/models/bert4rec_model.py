"""BERT4Rec model: encoder + tied-embedding MLM head + loss + ranking
(port of ``bert4rec_tpu/models/bert4rec_model.py``).

The MLM head gathers the masked positions, applies dense + activation +
LayerNorm, multiplies by the tied item-embedding table (a plain
``torch.matmul``, as the JAX package leaves that product to XLA), adds the
output bias and sets vocab-padding columns to -1e9. ``loss_and_metrics``
routes as JAX does: the fused tied-softmax loss (``ops/fused_mlm_loss.py``)
where ``config.use_fused_loss`` and the routing law allow it, else the
logits path with ``trainers/trainer_utils.py``. For evaluation,
``score_candidates`` scores only each position's candidates and
``gt_ranks_full_vocab`` ranks the ground truth against the whole catalog
(``ops/candidate_scoring.py``); ``rank_top_k``, ``rank_with_candidates``,
``rank_full_vocab`` and ``rank_items`` rank as the JAX model does.

On a ``(data, model)`` mesh (``core/mesh.py``) the params are this rank's
pieces (``core/partitioning.py``: the item table and the output bias
row-sharded over 'model' where the axis divides the padded vocab) and the
batch is its 'data' slice. ``loss_and_metrics``, ``score_candidates``,
``rank_top_k``, ``gt_ranks_full_vocab`` and ``apply`` take the ``mesh``:
the loss runs the vocab-sharded kernels (``ops/sharded_mlm_loss.py``,
with ``config.use_fused_loss``), scoring and ranking run shard-local with
only per-row results crossing the ranks, and any other path gathers the
table over 'model' first (what GSPMD does for JAX). Losses and metrics
are means over the global batch on every rank.
"""

from typing import Optional, Sequence

import torch

from bert4rec_tpu_torch.core import mesh as mesh_lib
from bert4rec_tpu_torch.core import partitioning
from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.core.mesh import MODEL_AXIS
from bert4rec_tpu_torch.core.dtypes import DTypePolicy
from bert4rec_tpu_torch.models import model_utils
from bert4rec_tpu_torch.models.components import layers as L
from bert4rec_tpu_torch.models.components.networks import Bert4RecEncoder
from bert4rec_tpu_torch.models.config import BERT4RecConfig
from bert4rec_tpu_torch.ops import sharded_topk

# [PAD], [MASK], [UNK] — ids 0/1/2 by the dataloader's construction
SPECIAL_TOKEN_IDS = [0, 1, 2]


class BERT4RecModel:
    """Encoder + MLM head over one param dict ``{"encoder", "mlm"}``."""

    def __init__(self,
                 encoder: Bert4RecEncoder = None,
                 config: BERT4RecConfig = None,
                 special_token_ids: Sequence[int] = tuple(SPECIAL_TOKEN_IDS),
                 dtype_policy: Optional[DTypePolicy] = None):
        if encoder is None:
            if config is None:
                raise ValueError("Provide either an encoder or a config")
            encoder = Bert4RecEncoder(config, dtype_policy)
        self.encoder = encoder
        self.config = encoder.config
        self.dtype_policy = dtype_policy or encoder.dtype_policy
        self.special_token_ids = list(special_token_ids)

    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> dict:
        """Fresh params (TF-style truncated normal from ``generator``,
        sampled on the CPU, then moved to ``device``). ``device="meta"``
        gives the structure and shapes only."""
        if str(device) != "meta":
            device = resolve_device(device)
        cfg = self.config
        encoder_params = self.encoder.init(generator, device)
        mlm_params = {
            "transform": L.init_dense(generator, cfg.hidden_size,
                                      cfg.table_width,
                                      cfg.initializer_range, device),
            "transform_norm": L.init_layer_norm(cfg.table_width, device),
            "output_bias": torch.zeros((cfg.padded_vocab_size,),
                                       dtype=torch.float32, device=device),
        }
        return {"encoder": encoder_params, "mlm": mlm_params}

    # ------------------------------------------------------------------ #

    def mlm_transform(self, params: dict, sequence_output: torch.Tensor,
                      masked_lm_positions: torch.Tensor) -> torch.Tensor:
        """Gather masked positions and apply the MLM transform -> [B, P, W]."""
        compute_dtype = self.dtype_policy.compute_dtype
        idx = masked_lm_positions.long()[..., None].expand(
            -1, -1, sequence_output.shape[-1])
        x = torch.gather(sequence_output, 1, idx)
        x = L.dense(params["mlm"]["transform"], x, compute_dtype)
        x = L.get_activation(self.config.inner_activation)(x)
        return L.layer_norm(params["mlm"]["transform_norm"], x)

    def mlm_logits(self, params: dict, sequence_output: torch.Tensor,
                   masked_lm_positions: torch.Tensor,
                   offset: int = 0) -> torch.Tensor:
        """Gather -> transform -> tied matmul -> fp32 logits ``[B, P, V]``
        (operands in the compute dtype, fp32 sums). With ``offset`` the
        params hold a vocab shard's block whose first row is item
        ``offset`` (its columns past the vocabulary padded to -1e9)."""
        compute_dtype = self.dtype_policy.compute_dtype
        x = self.mlm_transform(params, sequence_output, masked_lm_positions)
        emb = params["encoder"]["item_embeddings"]
        if "embedding_q" in emb:
            # int8 weights-only table (models/quantization.py): the product
            # takes the raw codes (exact in the compute dtype), then each
            # column is scaled; no dense dequantized [V, W] is built
            logits = torch.matmul(
                x.float(), emb["embedding_q"].to(compute_dtype).float().T)
            logits = logits * emb["embedding_scale"]
        else:
            table = Bert4RecEncoder.get_embedding_table(params["encoder"])
            logits = torch.matmul(x.float(),
                                  table.to(compute_dtype).float().T)
        logits = logits + params["mlm"]["output_bias"]
        first_pad = max(self.config.vocab_size - offset, 0)
        if first_pad < logits.shape[-1]:
            # vocab-padding ids must never win a ranking
            logits[..., first_pad:] = -1e9
        return logits

    def _mlm_hidden_and_table(self, params: dict, inputs: dict, *,
                              training: bool = False,
                              seed: Optional[int] = None,
                              dense_table: bool = True,
                              mesh=None) -> tuple:
        """Encoder forward + MLM transform of the masked positions + the
        tied table: the front half of the fused-loss path
        (``dense_table=False`` skips the table: the quantized fast paths
        read the raw quantized leaves)."""
        enc = self.encoder.apply(params["encoder"], inputs["input_word_ids"],
                                 inputs["input_mask"], training=training,
                                 seed=seed,
                                 input_timestamps=inputs.get(
                                     "input_timestamps"), mesh=mesh)
        hidden = self.mlm_transform(params, enc["sequence_output"],
                                    inputs["masked_lm_positions"])
        table = (Bert4RecEncoder.get_embedding_table(params["encoder"])
                 if dense_table else None)
        return hidden, table

    # ------------------------------------------------------------------ #
    # the mesh
    # ------------------------------------------------------------------ #

    def _sharded(self, params: dict, mesh) -> bool:
        """Whether ``params`` hold this rank's block of a table row-sharded
        over ``mesh``'s 'model' axis."""
        emb = params["encoder"]["item_embeddings"]
        return "embedding" in emb and partitioning.vocab_sharded(
            mesh, emb["embedding"].shape[0], self.config.padded_vocab_size)

    def _whole(self, params: dict, mesh) -> dict:
        """``params`` with a sharded table and bias gathered over 'model'
        (differentiable: each rank's gradient lands on its block)."""
        if not self._sharded(params, mesh):
            return params
        emb = params["encoder"]["item_embeddings"]
        return {
            "encoder": {**params["encoder"], "item_embeddings": {
                **emb, "embedding": mesh_lib.gather_rows(
                    mesh, emb["embedding"], MODEL_AXIS)}},
            "mlm": {**params["mlm"], "output_bias": mesh_lib.gather_rows(
                mesh, params["mlm"]["output_bias"], MODEL_AXIS)}}

    def score_candidates(self, params: dict, inputs: dict,
                         candidates: torch.Tensor,
                         mesh=None) -> torch.Tensor:
        """Candidate-only MLM logits ``[B, P, C]`` of ``candidates [B, P,
        C]``: never builds the ``[B, P, V]`` full-vocab logits (the
        sampled evaluation's path). An int8 table scales only the
        gathered candidate rows' products. ``mesh``: on vocab-sharded
        params each rank scores the candidates it owns
        (``candidate_scoring.score_candidates_sharded``)."""
        from bert4rec_tpu_torch.ops import candidate_scoring
        mesh = mesh_lib.as_mesh(mesh, "score_candidates")
        emb = params["encoder"]["item_embeddings"]
        if self._sharded(params, mesh):
            hidden, table = self._mlm_hidden_and_table(params, inputs,
                                                       mesh=mesh)
            return candidate_scoring.score_candidates_sharded(
                hidden, table, params["mlm"]["output_bias"], candidates,
                mesh)
        if "embedding_q" in emb:
            hidden, _ = self._mlm_hidden_and_table(params, inputs,
                                                   dense_table=False)
            return candidate_scoring.score_candidates_quantized(
                hidden, emb, params["mlm"]["output_bias"], candidates)
        hidden, table = self._mlm_hidden_and_table(params, inputs)
        return candidate_scoring.score_candidates(
            hidden, table, params["mlm"]["output_bias"], candidates)

    def loss_and_metrics(self, params: dict, inputs: dict, *,
                         training: bool = False,
                         seed: Optional[int] = None,
                         mesh=None) -> tuple:
        """(masked-SCCE loss, {masked_accuracy, accuracy}) for a train or
        eval step. With ``config.use_fused_loss`` the tied softmax, loss
        and metrics run as the fused kernels (no ``[B, P, V]`` logits);
        otherwise the same math over the logits path.

        ``mesh``: the params are this rank's pieces and ``inputs`` its
        'data' slice; the loss and metrics are the global batch's. With
        the table vocab-sharded (the 'model' axis > 1 divides the padded
        vocab) and ``use_fused_loss``, the sharded kernels run
        (``ops/sharded_mlm_loss.py``); otherwise the path below on the
        gathered table."""
        mesh = mesh_lib.as_mesh(mesh, "loss_and_metrics")
        labels = inputs["masked_lm_ids"]
        if self.config.use_fused_loss and self._sharded(params, mesh):
            from bert4rec_tpu_torch.ops.sharded_mlm_loss import (
                sharded_mlm_loss_and_metrics,
            )
            hidden, table = self._mlm_hidden_and_table(
                params, inputs, training=training, seed=seed, mesh=mesh)
            return sharded_mlm_loss_and_metrics(
                hidden, table, params["mlm"]["output_bias"], labels,
                self.config.vocab_size, mesh)
        loss, logs = self._loss_and_metrics(self._whole(params, mesh),
                                            inputs, training, seed)
        from bert4rec_tpu_torch.trainers import trainer_utils
        return trainer_utils.global_means(mesh, loss, logs, labels)

    def _loss_and_metrics(self, params, inputs, training, seed) -> tuple:
        from bert4rec_tpu_torch.ops import fused_mlm_loss
        from bert4rec_tpu_torch.trainers import trainer_utils
        labels = inputs["masked_lm_ids"]
        cfg = self.config
        if cfg.use_fused_loss and fused_mlm_loss.fused_loss_available(
                cfg.padded_vocab_size, cfg.table_width):
            hidden, table = self._mlm_hidden_and_table(
                params, inputs, training=training, seed=seed)
            return fused_mlm_loss.mlm_loss_and_metrics(
                hidden, table, params["mlm"]["output_bias"], labels,
                cfg.vocab_size)
        logits = self.apply(params, inputs, training=training,
                            seed=seed)["mlm_logits"]
        loss = trainer_utils.masked_sparse_categorical_crossentropy(
            labels, logits)
        return loss, {
            "masked_accuracy": trainer_utils.masked_accuracy(labels, logits),
            "accuracy": trainer_utils.sparse_categorical_accuracy(labels,
                                                                  logits),
        }

    def apply(self, params: dict, inputs: dict, *, training: bool = False,
              seed: Optional[int] = None,
              apply_prediction_mask: bool = False,
              output_range: Optional[int] = None, mesh=None) -> dict:
        """Forward pass over the feature dict; ``mlm_logits`` is produced
        iff ``masked_lm_positions`` is present. Dropout runs only when
        ``training`` with a ``seed``. ``apply_prediction_mask`` adds -1e9
        to the special tokens' logits (off by default, as in the
        reference); ``output_range`` computes only the first positions of
        the last encoder layer. ``mesh``: vocab-sharded params are
        gathered over 'model' first (the whole ``[B, P, V]`` logits)."""
        params = self._whole(params, mesh_lib.as_mesh(mesh, "apply"))
        outputs = dict(self.encoder.apply(
            params["encoder"], inputs["input_word_ids"],
            inputs["input_mask"], training=training, seed=seed,
            output_range=output_range,
            input_timestamps=inputs.get("input_timestamps")))
        if "masked_lm_positions" in inputs:
            logits = self.mlm_logits(params, outputs["sequence_output"],
                                     inputs["masked_lm_positions"])
            if apply_prediction_mask and self.special_token_ids:
                # as wide as the logits (padded_vocab_size)
                mask = torch.zeros((self.config.padded_vocab_size,),
                                   dtype=torch.float32, device=logits.device)
                mask[self.special_token_ids] = -1e9
                logits = logits + mask
            outputs["mlm_logits"] = logits
        return outputs

    # ------------------------------------------------------------------ #
    # ranking (JAX bert4rec_model.py:255-288, :385-394)
    # ------------------------------------------------------------------ #

    def rank_with_candidates(self, params: dict, inputs: dict,
                             candidates: torch.Tensor, *,
                             with_probabilities: bool = True) -> tuple:
        """Rank per-position candidate lists ``candidates [B, P, C]``:
        ``(rankings [B, P, C]`` ids best first, ``probabilities [B, P, V]``
        softmax over the vocab, or None without ``with_probabilities``)."""
        return model_utils.rank_items(
            self.apply(params, inputs)["mlm_logits"], items=candidates,
            with_probabilities=with_probabilities)

    def rank_full_vocab(self, params: dict, inputs: dict, *,
                        with_probabilities: bool = True) -> tuple:
        """Rank the whole vocabulary per masked position: ``rankings
        [B, P, V]`` best first, and the softmax probabilities (None without
        ``with_probabilities``)."""
        return model_utils.rank_items(
            self.apply(params, inputs)["mlm_logits"],
            with_probabilities=with_probabilities)

    def rank_items(self, params: dict, encoder_input: dict,
                   rank_items_list=None) -> tuple:
        """The reference's signature: ``rank_items_list [B, P, C]`` ranks
        those candidates, None the whole vocabulary."""
        if rank_items_list is None:
            return self.rank_full_vocab(params, encoder_input)
        return self.rank_with_candidates(
            params, encoder_input,
            torch.as_tensor(rank_items_list,
                            device=encoder_input["input_word_ids"].device))

    def _local_logits(self, params: dict, inputs: dict, mesh
                      ) -> torch.Tensor:
        """This rank's block ``[B, P, V / mp]`` of the fp32 logits of
        vocab-sharded params (the padding columns at -1e9)."""
        enc = self.encoder.apply(params["encoder"], inputs["input_word_ids"],
                                 inputs["input_mask"], mesh=mesh,
                                 input_timestamps=inputs.get(
                                     "input_timestamps"))
        v_local = params["mlm"]["output_bias"].shape[0]
        return self.mlm_logits(params, enc["sequence_output"],
                               inputs["masked_lm_positions"],
                               offset=mesh.index(MODEL_AXIS) * v_local)

    def rank_top_k(self, params: dict, inputs: dict, k: int, *,
                   mesh=None,
                   exclude: Optional[torch.Tensor] = None,
                   with_probabilities: bool = False) -> tuple:
        """Top-k full-vocab ranking per masked position.

        :param mesh: on vocab-sharded params each rank ranks its block and
            only ``mp * k`` pairs cross the ranks (``ops/sharded_topk.py``);
            the ``[B, P, V]`` logits are never gathered
        :param exclude: optional ``[B, E]`` int ids (< 0 = padding) knocked
            out per batch row across all positions (an additive -1e9)
        :param with_probabilities: return softmax probabilities of the
            top-k items (one logsumexp over V) instead of logits
        :returns: ``(top_ids [B, P, k], top_scores [B, P, k])``
        """
        mesh = mesh_lib.as_mesh(mesh, "rank_top_k")
        if self._sharded(params, mesh):
            logits = self._local_logits(params, inputs, mesh)
            offset = mesh.index(MODEL_AXIS) * logits.shape[-1]
        else:
            logits = self.apply(params, inputs)["mlm_logits"]  # [B, P, V]
            mesh, offset = None, 0
        if exclude is not None:
            bias = sharded_topk.exclusion_bias(exclude, logits.shape[-1],
                                               offset=offset)
            logits = logits + bias[:, None, :]
        values, ids = sharded_topk.topk_over_vocab(logits, k, mesh=mesh)
        if with_probabilities:
            lse = torch.logsumexp(logits, dim=-1, keepdim=True)
            if mesh is not None:
                # the global logsumexp from the blocks' (max, sum)
                m = mesh_lib.all_reduce(mesh, lse.clone(), MODEL_AXIS, "max")
                lse = m + torch.log(mesh_lib.all_reduce(
                    mesh, torch.exp(lse - m), MODEL_AXIS))
            return ids, torch.exp(values - lse)
        return ids, values

    # vocab width above which gt_ranks_full_vocab streams the table in
    # tiles instead of materialising [B, P, V] fp32 logits (the JAX
    # package's threshold)
    TILED_RANK_VOCAB_THRESHOLD = 65536

    def gt_ranks_full_vocab(self, params: dict, inputs: dict, *,
                            exclude: Optional[torch.Tensor] = None,
                            vocab_tile: Optional[int] = None,
                            mesh=None) -> torch.Tensor:
        """1-based rank of each masked position's ground truth against the
        whole catalog (the unsampled protocol): 1 + the non-excluded
        catalog items whose logit ties or beats the ground truth's; the
        ground-truth column never counts itself. Above
        ``TILED_RANK_VOCAB_THRESHOLD`` (or with ``vocab_tile``) the same
        law runs tile by tile (``candidate_scoring.gt_ranks_tiled``).

        :param exclude: optional ``[B, E]`` int ids (< 0 = padding) removed
            from the competitor set per batch row
        :param mesh: on vocab-sharded params each rank counts the
            competitors on its block (``candidate_scoring.gt_ranks_sharded``)
        :returns: ``[B, P]`` int32 ranks (>= 1)
        """
        gt_ids = inputs["masked_lm_ids"].long()
        mesh = mesh_lib.as_mesh(mesh, "gt_ranks_full_vocab")
        if self._sharded(params, mesh):
            from bert4rec_tpu_torch.ops import candidate_scoring
            hidden, table = self._mlm_hidden_and_table(params, inputs,
                                                       mesh=mesh)
            return candidate_scoring.gt_ranks_sharded(
                hidden, table, params["mlm"]["output_bias"], gt_ids,
                vocab_size=self.config.vocab_size, mesh=mesh,
                exclude=exclude, tile=vocab_tile or 8192)
        if (vocab_tile is not None or self.config.padded_vocab_size
                > self.TILED_RANK_VOCAB_THRESHOLD):
            from bert4rec_tpu_torch.ops import candidate_scoring
            hidden, table = self._mlm_hidden_and_table(params, inputs)
            return candidate_scoring.gt_ranks_tiled(
                hidden, table, params["mlm"]["output_bias"], gt_ids,
                vocab_size=self.config.vocab_size, exclude=exclude,
                tile=vocab_tile or 8192)
        logits = self.apply(params, inputs)["mlm_logits"]    # [B, P, V]
        gt = torch.gather(logits, -1, gt_ids[..., None])
        if exclude is not None:
            logits = logits + sharded_topk.exclusion_bias(
                exclude, logits.shape[-1])[:, None, :]
        logits = logits.scatter(-1, gt_ids[..., None], -1e9)
        return (logits >= gt).sum(-1, dtype=torch.int32) + 1

    # ------------------------------------------------------------------ #

    def get_config(self) -> dict:
        return self.config.to_dict()

    @classmethod
    def from_config(cls, config: dict, **kwargs) -> "BERT4RecModel":
        return cls(config=BERT4RecConfig.from_dict(config), **kwargs)
