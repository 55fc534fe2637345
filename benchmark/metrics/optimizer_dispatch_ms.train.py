"""Mean host ms per ``trainer.step`` in ``trainer.optimizer``, its self
time: the clip and AdamW's launches, from the untraced window's program
spans (``obs.program``)."""

from benchmark import program_spans


def read(obs):
    log = getattr(obs, "program", None)
    return program_spans.per_step_ms(log, ("trainer.optimizer",),
                                     self_time=True) if log else None
