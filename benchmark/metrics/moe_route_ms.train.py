"""Device ms per step of the operations launched inside the program's
``moe.route`` and ``moe.combine`` spans (the router, the biased top-k,
the sort by expert, the rows' copy into that order, the un-permute and
the weighted sum; their forward launches: the backward's are launched by
autograd's thread under ``trainer.backward``), over the traced window
(``launch_spans.attribute``)."""


def read(obs):
    device = getattr(obs, "device_by_span", None)
    steps = getattr(obs, "traced_steps", 0)
    if not device or not steps:
        return None
    return 1e3 * (device.get("moe.route", 0.0)
                  + device.get("moe.combine", 0.0)) / steps
