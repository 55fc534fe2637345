"""Mean host ms per masked batch of the input pipeline (the dataset's
``batches()`` iterator: masking and batching, run on the prefetch thread),
from the untraced window's benchmark span around each ``next``."""


def read(obs):
    return obs.spans.mean_ms("bench.pipeline")
