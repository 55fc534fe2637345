"""Ranker inference app (port of ``bert4rec_tpu/apps/ranker.py``).

Ranks a target item for a raw history, within the full vocab or a candidate
subset; returns the 1-based rank plus a human-readable string.

As in JAX, the reference's negated MLM logits are not copied: a higher
logit ranks better, and the rank is the count of logits that tie or beat
the target's (the target counts itself once), the evaluator's tie law, so
app ranks and evaluation metrics agree on tied scores.
"""

from typing import List, Optional, Union

import torch

from bert4rec_tpu_torch.apps.recommender import model_inputs, _to_device
from bert4rec_tpu_torch.core.device import resolve_device
from bert4rec_tpu_torch.models.components.networks import Bert4RecEncoder


def _mask_vocab_padding(logits: torch.Tensor, config) -> torch.Tensor:
    """Knock out vocab-padding columns in tied-matmul fallback scores:
    ``mlm_logits`` masks them itself; the raw ``hidden @ table^T``
    fallback must do the same, or random padding embeddings pollute
    ranks."""
    if config.padded_vocab_size > config.vocab_size:
        col = torch.arange(config.padded_vocab_size, device=logits.device)
        logits = torch.where(col >= config.vocab_size, -1e9, logits)
    return logits


class Ranker:
    """A model + params + dataloader on one device.

    :param device: where the params are moved and every forward runs;
        defaults to ``"cuda"`` and raises without CUDA unless ``"cpu"`` is
        asked for.
    """

    def __init__(self, model, params, dataloader, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.params = _to_device(params, self.device)
        self.dataloader = dataloader

    def _logits_row(self, inputs: dict, use_mlm_head: bool) -> torch.Tensor:
        """The masked slot's logits ``[V]``."""
        out = self.model.apply(self.params, inputs)
        if use_mlm_head and "mlm_logits" in out:
            return out["mlm_logits"][0, 0]
        # tied-matmul fallback (the reference's ranker.py:38-54)
        pos = inputs["masked_lm_positions"][0, 0].long()
        hidden = out["sequence_output"][0, pos]
        table = Bert4RecEncoder.get_embedding_table(self.params["encoder"])
        logits = table.float() @ hidden.float()
        return _mask_vocab_padding(logits, self.model.config)

    @torch.inference_mode()
    def __call__(self, sequence: List[str],
                 rank_item: Optional[str] = None,
                 rank_items: Optional[List[str]] = None,
                 use_mlm_head: bool = True) -> Union[tuple, list]:
        """Rank ``rank_item`` (or each of ``rank_items``) for the history.

        :returns: ``(rank, text)`` for a single item, else a list of
            ``(item, rank)`` pairs ordered by rank.
        """
        if rank_item is None and rank_items is None:
            raise ValueError("Provide rank_item or rank_items to rank.")
        inputs = model_inputs(
            self.dataloader.prepare_inference(list(sequence)), self.model,
            self.device)
        tok = self.dataloader.tokenizer
        logits = self._logits_row(inputs, use_mlm_head)

        if rank_items is not None:
            ids = torch.as_tensor(tok.tokenize(list(rank_items)),
                                  dtype=torch.long, device=self.device)
            order = torch.argsort(-logits[ids], stable=True).cpu().tolist()
            return [(rank_items[i], r + 1) for r, i in enumerate(order)]

        target = logits[int(tok.tokenize(rank_item))]
        # 1-based rank within the full vocab; ties count against the target
        rank = int((logits >= target).sum())
        text = (f"The item '{rank_item}' was ranked {rank} out of "
                f"{self.model.config.vocab_size} items for the given "
                f"sequence.")
        return rank, text
