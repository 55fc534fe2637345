"""Mean ms per ``trainer.step`` inside ``trainer.sync`` spans: the time
the step blocks the host until the card catches up, from the untraced
window's program spans (``obs.program``)."""

from benchmark import program_spans


def read(obs):
    log = getattr(obs, "program", None)
    return program_spans.per_step_ms(log, ("trainer.sync",)) if log \
        else None
