"""Mean ms per ``trainer.step`` the main thread waits in ``pipeline.wait``
for the prefetch queue's next batch (top-level spans of the steps'
thread), from the untraced window's program spans (``obs.program``)."""

from benchmark import program_spans


def read(obs):
    log = getattr(obs, "program", None)
    return program_spans.per_step_ms(log, ("pipeline.wait",), within=None) \
        if log else None
