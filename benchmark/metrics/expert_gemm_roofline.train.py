"""K11's share of its roofline over the traced window: the least time of
every forward and backward launch (``roofline_mla_moe.expert_s`` at the
rows the router counted, shared evenly by the window's launches) over the
device time of the expert GEMM kernels in the trace
(``csrc/expert_gemm.cu``), in %."""

KERNELS = ("expert_gate_up_kernel", "expert_rows_kernel",
           "expert_wgrad_kernel")


def read(obs):
    c = obs.counts
    if obs.trace is None or not c.get("expert_fwd"):
        return None
    rows = c["routed_rows"] / c["expert_fwd"]
    r = obs.roofline
    bound = (c["expert_fwd"] * r.expert_s(rows, obs.model, False)
             + c["expert_bwd"] * r.expert_s(rows, obs.model, True))
    spent = sum(s for n, s in obs.trace.kernels
                if any(k in n for k in KERNELS))
    return 100.0 * bound / spent if spent else None
