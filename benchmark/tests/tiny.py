"""A tiny size for driving whole runs on the CPU."""

import contextlib
import io
import json

from benchmark import run

# the tiny size's own limits, set as the cells' are, from CPU readings of
# the sound program (bf16: loss <= 3e-5, gradient and change gaps <= 5e-3)
# and of the control (float8: loss >= 2.7e-4) and the faults
TINY_LIMITS = {"loss": 1e-4, "grad": 0.05, "change": 0.05}


def adjust(conf: dict, traffic: dict) -> None:
    conf["limits"] = dict(TINY_LIMITS)
    conf["model"].update(
        vocab_size=203, hidden_size=32, num_layers=2, num_attention_heads=2,
        inner_dim=64, max_sequence_length=24, max_predictions_per_seq=5)
    conf["training"]["batch_size"] = 8
    traffic.update(users=96, min_len=5, median_len=10.0, mean_len=14.0,
                   max_len=60, items=200)


def run_cell(workload: str, seed: int = 2 ** 31 + 5, trace: int = 0,
             seconds: float = 1.0) -> tuple:
    """(exit code, parsed last stdout line or None, stderr) of one CPU run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = run.main(["--workload", workload, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)],
                        require_cuda=False, adjust=adjust)
    lines = out.getvalue().strip().splitlines()
    return code, (json.loads(lines[-1]) if lines else None), err.getvalue()
