"""Kernels of the port and their plain versions. Importing this package
builds nothing: CUDA sources compile at a kernel's first launch
(``kernel_build``)."""

from bert4rec_tpu_torch.ops.candidate_scoring import (
    score_candidates, score_candidates_reference,
)
from bert4rec_tpu_torch.ops.flash_attention import flash_attention, mha_reference
from bert4rec_tpu_torch.ops.sharded_topk import exclusion_bias, topk_over_vocab

__all__ = ["flash_attention", "mha_reference", "score_candidates",
           "score_candidates_reference", "topk_over_vocab",
           "exclusion_bias"]
