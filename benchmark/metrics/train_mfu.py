"""The untraced window's model operations (``roofline.train_step_flops``
per step, no recomputation) over its host time at the published bf16 peak
of 989 TFLOP/s, in %. Only on the card."""


def read(obs):
    if not obs.steps or not obs.cuda:
        return None
    flops = obs.steps * obs.roofline.train_step_flops(obs.model, obs.batch)
    return 100.0 * flops / (obs.window_s * obs.roofline.PEAK_FLOPS[
        "bfloat16"])
