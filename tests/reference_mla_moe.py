"""The plain float32 reference of the ``mla_moe`` block for the CPU tests:
the benchmark's own, ``benchmark/reference/mla_moe.py`` (plain PyTorch,
nothing of the port or of JAX), so the tests and the benchmark hold the
port to one file."""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from benchmark.reference.mla_moe import *  # noqa: E402,F401,F403
