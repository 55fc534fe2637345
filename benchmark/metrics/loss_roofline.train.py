"""The vocab-tiled loss's share of its roofline over the window: the
least time of every K5 and K6 (or K7) launch over the device time of the
loss kernels in the trace (``csrc/loss_hopper.cuh``, and the ordered merge
and the cast of ``csrc/fused_mlm_loss.cu``), in %."""

import re

KERNELS = re.compile(r"loss_hopper::|loss_tiled_merge_kernel|"
                     r"reduce_rows_cast_kernel")


def read(obs):
    c = obs.counts
    if obs.trace is None or not c["loss_tiled_fwd"]:
        return None
    m = obs.model
    rows = obs.batch * m["max_predictions_per_seq"]
    v, w = m["vocab_size"], m["hidden_size"]
    r = obs.roofline
    bound = (c["loss_tiled_fwd"] * r.loss_s(rows, v, w, False, obs.dtype)
             + (c["loss_merged_bwd"] + c["loss_two_sweep_bwd"])
            * r.loss_s(rows, v, w, True, obs.dtype))
    spent = sum(s for n, s in obs.trace.kernels if KERNELS.search(n))
    return 100.0 * bound / spent if spent else None
