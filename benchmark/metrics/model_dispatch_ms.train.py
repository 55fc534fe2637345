"""Mean host ms per ``trainer.step`` in ``trainer.forward`` and
``trainer.backward``, their self time (less their ``trainer.sync``
children): the model's dispatch, from the untraced window's program spans
(``obs.program``)."""

from benchmark import program_spans


def read(obs):
    log = getattr(obs, "program", None)
    return program_spans.per_step_ms(
        log, ("trainer.forward", "trainer.backward"), self_time=True) \
        if log else None
