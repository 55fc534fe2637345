"""Mean host ms per ``BERT4RecTrainer.train_step`` call (forward,
backward and optimizer dispatch), from the untraced window's benchmark
span around the bound method."""


def read(obs):
    return obs.spans.mean_ms("bench.train_step")
