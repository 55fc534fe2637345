"""One-command release validation of the port: what must pass before
shipping, in order. The counterpart of ``tools/release_check.py:70-119``,
with its flags and its output line.

    python -m bert4rec_tpu_torch.tools.release_check             # all
    python -m bert4rec_tpu_torch.tools.release_check --fast      # no suite
    python -m bert4rec_tpu_torch.tools.release_check --cpu-only  # no card

Stages, each a subprocess from the repository's root with a deadline:

1. ``cpu-suite``      the port's CPU tests, ``tests/test_torch_*.py``, on
                      4 pytest-xdist workers (skipped with ``--fast``);
2. ``bench-smoke``    ``tools.bench --smoke``;
3. ``quality-smoke-bert4rec`` / ``-sasrec``  ``tools.quality_run --smoke``
                      for both families on the CPU;

then, unless ``--cpu-only``, on the card:

4. ``chip-smoke``     ``python3 chip_smoke.py``;
5. ``card-tests``     ``pytest --noconftest -m cuda
                      tests/test_torch_cuda_kernels.py``;
6. ``perf-guard``     ``tools.perf_guard --numerics``;
7. ``quality-ml1m-scale`` / ``-ml20m-scale``  ``tools.quality_run --smoke
                      --smoke-scale ml1m`` and ``ml20m`` on the card.

The last line printed is one JSON object, ``{"release_check": "PASS" or
"FAIL", "stages": {name: {"ok": ..., "seconds": ...}}}``, and the exit
code is 1 when any stage failed.

Left out, and why: the JAX tool's first stage, the self-test of
``__graft_entry__.py`` (a JAX package file), and its cool-downs and retry
of a wedged TPU claim (``tools/release_check.py:36-67``): the card is
local and a stage that fails fails the check.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
PY = sys.executable


def stages(fast: bool = False, cpu_only: bool = False,
           out_dir: str = "quality_runs/torch/release") -> list:
    """``[(name, command, timeout s)]`` in the order they run."""
    tool = [PY, "-m"]
    pkg = "bert4rec_tpu_torch.tools."
    plan = []
    if not fast:
        suite = sorted(str(p.relative_to(REPO))
                       for p in (REPO / "tests").glob("test_torch_*.py"))
        plan.append(("cpu-suite", [PY, "-m", "pytest", "-q", "-n", "4",
                                   "--dist", "loadfile", *suite], 1800))
    plan.append(("bench-smoke", tool + [pkg + "bench", "--smoke"], 300))
    for family in ("bert4rec", "sasrec"):
        plan.append((f"quality-smoke-{family}", tool + [
            pkg + "quality_run", "--smoke", "--smoke-family", family,
            "--device", "cpu", "--out", f"{out_dir}/smoke_{family}"], 600))
    if not cpu_only:
        plan.append(("chip-smoke", [PY, "chip_smoke.py"], 1500))
        plan.append(("card-tests", [PY, "-m", "pytest", "--noconftest", "-m",
                                    "cuda", "tests/test_torch_cuda_kernels.py",
                                    "-q"], 900))
        plan.append(("perf-guard", tool + [pkg + "perf_guard", "--numerics"],
                     1500))
        for scale in ("ml1m", "ml20m"):
            plan.append((f"quality-{scale}-scale", tool + [
                pkg + "quality_run", "--smoke", "--smoke-scale", scale,
                "--out", f"{out_dir}/{scale}"], 900))
    return plan


def run_stage(name, cmd, timeout) -> tuple:
    """Run one stage from the repository's root; ``(ok, seconds)``. The
    CPU suite's parity tests import JAX: ``JAX_PLATFORMS=cpu`` keeps it on
    the CPU (no other stage imports it)."""
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, cwd=str(REPO), capture_output=True,
                              text=True, timeout=timeout,
                              env={**os.environ, "JAX_PLATFORMS": "cpu"})
    except subprocess.TimeoutExpired:
        dt = time.time() - t0
        print(f"[release] FAIL {name}: timed out after {dt:.0f}s",
              flush=True)
        return False, dt
    dt = time.time() - t0
    if proc.returncode == 0:
        print(f"[release] ok   {name} ({dt:.0f}s)", flush=True)
        return True, dt
    tail = (proc.stdout[-1500:] + proc.stderr[-1500:]).strip()
    print(f"[release] FAIL {name} (exit {proc.returncode}, {dt:.0f}s)\n"
          f"{tail}", flush=True)
    return False, dt


def main(argv=None, runner=run_stage) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fast", action="store_true",
                   help="skip the port's CPU test suite")
    p.add_argument("--cpu-only", action="store_true",
                   help="skip the card's stages")
    args = p.parse_args(argv)
    results = {}
    with tempfile.TemporaryDirectory(prefix="release_check_") as tmp:
        for name, cmd, timeout in stages(args.fast, args.cpu_only, tmp):
            ok, dt = runner(name, cmd, timeout)
            results[name] = {"ok": bool(ok), "seconds": round(dt, 1)}
    ok = all(r["ok"] for r in results.values())
    print(json.dumps({"release_check": "PASS" if ok else "FAIL",
                      "stages": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
