"""The fused encoder layer's share of its roofline over the window: the
least time of every K1' and K2 launch (from the launch counters and the
shapes) over the device time of the layer's kernels in the trace
(``csrc/layer_hopper.cuh`` and the attention it runs on
``csrc/flash_hopper.cuh``), in %."""

import re

KERNELS = re.compile(r"layer_hopper::|hopper::flash_|keep_scale_kernel")


def read(obs):
    c = obs.counts
    if obs.trace is None or not c["layer_fwd"]:
        return None
    m = obs.model
    args = (obs.batch, m["max_sequence_length"], m["hidden_size"],
            m["inner_dim"], obs.dtype)
    bound = (c["layer_fwd"] * obs.roofline.layer_forward_s(*args)
             + c["layer_bwd"] * obs.roofline.layer_backward_s(*args))
    spent = sum(s for n, s in obs.trace.kernels if KERNELS.search(n))
    return 100.0 * bound / spent if spent else None
