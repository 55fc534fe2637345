"""Flash attention's share of its roofline in the ``mla_moe`` block over
the traced window: the least time of every K8 and K9 launch at the
block's (DK, DV) = (qk_nope + qk_rope, v_head_dim), causal pairs counted
(``roofline_mla_moe.flash_s``), over the device time of the flash kernels
in the trace (``csrc/flash_hopper.cuh``), in %."""

import re

KERNELS = re.compile(r"hopper::flash_")


def read(obs):
    c = obs.counts
    if obs.trace is None or not c.get("flash_fwd"):
        return None
    r = obs.roofline
    bound = (c["flash_fwd"] * r.flash_s(obs.model, obs.batch, False)
             + c["flash_bwd"] * r.flash_s(obs.model, obs.batch, True))
    spent = sum(s for n, s in obs.trace.kernels if KERNELS.search(n))
    return 100.0 * bound / spent if spent else None
