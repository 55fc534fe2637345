"""Device ms per ``trainer.step`` of the operations launched inside
``trainer.optimizer`` (``benchmark/launch_spans.py``), over the traced
window (``obs.device_by_span`` and its spans, ``obs.program_traced``)."""

from benchmark import program_spans


def read(obs):
    device = getattr(obs, "device_by_span", None)
    log = getattr(obs, "program_traced", None)
    if not device or not log or not program_spans.steps(log):
        return None
    return 1e3 * device.get("trainer.optimizer", 0.0) \
        / len(program_spans.steps(log))
