"""Flash attention's share of its roofline over the window: the least
time of every K8 and K9 launch over the device time of the flash kernels
in the trace (``csrc/flash_hopper.cuh``), in %."""

import re

KERNELS = re.compile(r"hopper::flash_")


def read(obs):
    c = obs.counts
    if obs.trace is None or not c["flash_fwd"]:
        return None
    m = obs.model
    n = m["num_attention_heads"]
    dims = (obs.batch, n, m["max_sequence_length"], m["hidden_size"] // n)
    r = obs.roofline
    bound = (c["flash_fwd"] * r.flash_s(*dims, False, obs.dtype)
             + c["flash_bwd"] * r.flash_s(*dims, True, obs.dtype))
    spent = sum(s for n_, s in obs.trace.kernels if KERNELS.search(n_))
    return 100.0 * bound / spent if spent else None
