"""Recommender inference app (port of ``bert4rec_tpu/apps/recommender.py``).

Raw item-string histories -> ``prepare_inference(_batch)`` (append
``[UNK]``, last-token mask) -> forward on ``device`` -> MLM logits of the
masked slot -> seen items and special tokens excluded -> best items ->
detokenize. ``ArtifactRecommender`` serves the same ranking from an
exported program (``models/export.py``) without the model's code.
"""

from typing import List, Optional

import numpy as np
import torch

from bert4rec_tpu_torch.core import mesh as mesh_lib
from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.models.components.networks import Bert4RecEncoder

_WANTED = ("input_word_ids", "input_mask", "masked_lm_positions")


def build_exclusion_rows(sequences, tokenizer, special_token_ids,
                         width: Optional[int] = None) -> np.ndarray:
    """``[B, W]`` int32 exclusion rows: each history's seen item ids + the
    special ids, padded with -1. ``width=None`` pads W to a power of two
    (>= 8); a fixed ``width`` raises when a row cannot fit."""
    seen_lists = [np.asarray(tokenizer.tokenize(list(s)), dtype=np.int32)
                  for s in sequences]
    specials = np.asarray(list(special_token_ids), np.int32)
    longest = max((len(s) for s in seen_lists), default=0) + len(specials)
    if width is None:
        width = max(8, 1 << (max(longest, 1) - 1).bit_length())
    elif longest > width:
        raise ValueError(
            f"a history of {longest - len(specials)} items (+"
            f"{len(specials)} specials) exceeds the exclusion width "
            f"{width}; re-export with a larger num_exclude")
    rows = np.full((len(sequences), width), -1, dtype=np.int32)
    for i, seen in enumerate(seen_lists):
        row = np.concatenate([seen, specials])
        rows[i, :len(row)] = row
    return rows


def model_inputs(feats: dict, model, device) -> dict:
    """The prepared numpy features a forward reads, as tensors on
    ``device``; raises on item ids outside the model's vocabulary (an index
    past the table would fault on the device)."""
    ids = feats["input_word_ids"]
    vocab = model.config.padded_vocab_size
    if ids.size and (ids.min() < 0 or ids.max() >= vocab):
        raise ValueError(f"history holds item ids outside the model's "
                         f"vocabulary of {vocab}")
    return {k: torch.from_numpy(np.ascontiguousarray(feats[k])).to(device)
            for k in _WANTED}


class Recommender:
    """A model + params + dataloader on one device.

    :param device: where the params are moved and every forward runs;
        defaults to ``"cuda"`` and raises without CUDA unless ``"cpu"`` is
        asked for.
    :param mesh: a ``core.mesh.Mesh`` whose rank holds ``params``' pieces
        (vocab-sharded over 'model'); every rank of the mesh serves the
        same requests, ranked by the model's shard-local top-k
        (``rank_top_k(mesh=...)``); the device is the mesh's.
    """

    def __init__(self, model, params, dataloader, device="cuda", mesh=None):
        self.mesh = mesh_lib.as_mesh(mesh, "Recommender")
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self.model = model
        self.params = _to_device(params, self.device)
        self.dataloader = dataloader

    def _batch(self, feats: dict) -> dict:
        return model_inputs(feats, self.model, self.device)

    @torch.inference_mode()
    def __call__(self, sequence: List[str],
                 use_mlm_head: bool = True) -> str:
        """Recommend the next item for a raw item-string history."""
        model_input = self.dataloader.prepare_inference(list(sequence))
        seen_ids = np.asarray(
            self.dataloader.tokenizer.tokenize(list(sequence)), dtype=np.int32)
        outputs = self.model.apply(self.params, self._batch(model_input),
                                   mesh=self.mesh)

        if use_mlm_head and "mlm_logits" in outputs:
            logits = outputs["mlm_logits"][0, 0]  # the masked slot is slot 0
        else:
            # tied-embedding fallback on the masked position's hidden state
            pos = int(model_input["masked_lm_positions"][0, 0])
            hidden = outputs["sequence_output"][0, pos]
            table = Bert4RecEncoder.get_embedding_table(
                self.model._whole(self.params, self.mesh)["encoder"])
            logits = table.float() @ hidden.float()
            cfg = self.model.config
            if cfg.padded_vocab_size > cfg.vocab_size:
                logits[cfg.vocab_size:] = -1e9

        vocab_size = logits.shape[-1]
        mask = np.zeros(vocab_size, dtype=np.float32)
        mask[seen_ids[seen_ids < vocab_size]] = -np.inf
        for sid in self.model.special_token_ids:  # never recommended
            mask[sid] = -np.inf
        best = int(torch.argmax(logits + torch.from_numpy(mask)
                                .to(logits.device)))
        return self.dataloader.tokenizer.detokenize(best)

    # ------------------------------------------------------------------ #
    # batched serving
    # ------------------------------------------------------------------ #

    def recommend_batch(self, sequences, top_k: int = 1):
        """Top-k next-item recommendations for many histories at once, best
        first; seen items and special tokens are excluded."""
        ids = self._dispatch_topk(sequences, top_k)
        return self._decode_topk(ids)

    @torch.inference_mode()
    def _dispatch_topk(self, sequences, top_k: int) -> torch.Tensor:
        """Prep + launch one request batch; returns the device ids
        ``[B, k]`` without waiting for the device."""
        tok = self.dataloader.tokenizer
        feats = self.dataloader.prepare_inference_batch(
            [list(s) for s in sequences])
        exclude = build_exclusion_rows(sequences, tok,
                                       self.model.special_token_ids)
        ids, _ = self.model.rank_top_k(
            self.params, self._batch(feats), int(top_k),
            exclude=torch.from_numpy(exclude).to(self.device),
            mesh=self.mesh)
        return ids[:, 0]

    def _decode_topk(self, ids, k: Optional[int] = None) -> list:
        tok = self.dataloader.tokenizer
        rows = ids.cpu().numpy() if isinstance(ids, torch.Tensor) \
            else np.asarray(ids)
        if k is not None:
            rows = rows[:, :k]
        return [[tok.detokenize(int(t)) for t in row] for row in rows]

    def recommend_stream(self, batches, top_k: int = 1,
                         fetch_workers: int = 2):
        """Pipelined :meth:`recommend_batch` over an iterable of history
        batches: batch k+1 is launched while batch k's ids are copied back
        on a worker thread. Yields one result list per batch, in order."""
        from bert4rec_tpu_torch.utils.prefetch import fetch_pipelined
        yield from fetch_pipelined(
            batches,
            dispatch=lambda seqs: self._dispatch_topk(seqs, top_k),
            fetch=self._decode_topk,
            workers=fetch_workers)


class ArtifactRecommender:
    """``recommend_batch`` over a weights-embedded exported program (a
    ``models.export.export_top_k(..., num_exclude=E)`` artifact, e.g. from
    ``load_artifact``) plus a dataloader (tokenizer + inference
    preprocessing): the deployment where the serving process ships no model
    code. A backend of :class:`~bert4rec_tpu_torch.apps.serving.
    RecommenderService`.

    ``k`` and the exclusion width are read off the program's input and
    output shapes; it must have been exported WITH ``num_exclude``
    (otherwise seen items could be recommended back). Inputs go to the
    device the program's weights lie on.
    """

    def __init__(self, artifact, dataloader,
                 special_token_ids=(0, 1, 2)):
        from bert4rec_tpu_torch.models import export
        ins = export.input_shapes(artifact)
        if len(ins) != 4:
            raise ValueError(
                "the artifact must be exported with num_exclude=E "
                "(export_top_k(..., num_exclude=...)) so seen items can "
                f"be excluded; got {len(ins)} inputs")
        self.artifact = artifact
        self.dataloader = dataloader
        self.special_token_ids = list(special_token_ids)
        # public so a serving layer can validate requests before they
        # reach a shared batch
        self.exclusion_width = int(ins[3][1])
        self.exported_k = int(export.output_shapes(artifact)[0][-1])
        self.device = next(iter(artifact.state_dict.values())).device
        self._call = artifact.module()

    @property
    def max_history_items(self) -> int:
        """Longest history this artifact can exclude."""
        return self.exclusion_width - len(self.special_token_ids)

    def recommend_batch(self, sequences, top_k: Optional[int] = None):
        """Top-k next-item recommendations, ranked by the artifact.

        :param top_k: <= the exported k (defaults to it)
        """
        k = self.exported_k if top_k is None else int(top_k)
        ids = self._dispatch_topk(sequences, k)
        # decode only the requested k of the exported_k columns
        return self._decode_topk(ids, k)

    @torch.inference_mode()
    def _dispatch_topk(self, sequences, top_k: Optional[int]):
        """Prep + launch through the artifact; returns the device ids
        ``[B, exported_k]`` without waiting for the device. ``top_k`` only
        validates: the artifact always ranks its exported k."""
        k = self.exported_k if top_k is None else int(top_k)
        if k > self.exported_k:
            raise ValueError(f"top_k={k} exceeds the artifact's exported "
                             f"k={self.exported_k}")
        feats = self.dataloader.prepare_inference_batch(
            [list(s) for s in sequences])
        exclude = build_exclusion_rows(sequences,
                                       self.dataloader.tokenizer,
                                       self.special_token_ids,
                                       width=self.exclusion_width)
        args = [torch.from_numpy(np.ascontiguousarray(feats[name],
                                                      dtype=np.int32))
                for name in _WANTED] + [torch.from_numpy(exclude)]
        ids, _ = self._call(*(a.to(self.device) for a in args))
        return ids[:, 0]   # the single masked position is slot 0

    _decode_topk = Recommender._decode_topk


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
