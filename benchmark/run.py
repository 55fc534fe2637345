"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Exits non-zero without a result when there is no CUDA device, fewer
devices than the cell asks for, no program beside the benchmark, or a
module of JAX or of the JAX package loaded by the end of the run. Every
number the correctness check compares is printed beside its limit, as the
last lines on standard error and under ``checks`` in the result line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every compiler cache at a fixed path inside the checkout
CACHE = ROOT / "benchmark" / "_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str, code: int = 2) -> int:
    print(f"benchmark: {message}", file=sys.stderr)
    return code


def main(argv=None, require_cuda: bool = True, adjust=None) -> int:
    """``require_cuda=False`` and ``adjust(config, traffic)`` are for the
    CPU tests, which drive a run at a tiny size on the CPU."""
    args = parse(argv)
    from benchmark import harness
    work, _, conf, traffic = harness.cell(args.workload)
    if adjust is not None:
        adjust(conf, traffic)
    import torch
    if require_cuda:
        if not torch.cuda.is_available():
            return fail("no CUDA device")
        if torch.cuda.device_count() < work["chips"]:
            return fail(f"{work['chips']} devices asked for, "
                        f"{torch.cuda.device_count()} present")
    try:
        import bert4rec_tpu_torch
    except ImportError:
        return fail("bert4rec_tpu_torch is not beside the benchmark")
    if ROOT not in pathlib.Path(bert4rec_tpu_torch.__file__).resolve().parents:
        return fail(f"bert4rec_tpu_torch loaded from outside the checkout "
                    f"({bert4rec_tpu_torch.__file__})")
    device = torch.device("cuda" if require_cuda else "cpu")
    ctx = types.SimpleNamespace(
        workload=work["name"], config=conf, traffic=traffic,
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        t_start=T_START, device=device, chips=work["chips"])
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    out = driver.run(ctx)
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"modules of JAX or the JAX package were loaded: {bad}",
                    3)
    info = {"platform": "gpu" if require_cuda else "cpu",
            "kind": (torch.cuda.get_device_name(0) if require_cuda
                     else "cpu"),
            "count": work["chips"], "memory_peak_bytes": out["memory"]}
    trace = out["extra"].pop("trace", None)
    if trace is not None:
        info.update(busy_s=trace.busy_s, window_s=trace.window_s)
    if require_cuda:
        print(f"card: {harness.power_limit()}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(out["correct"], out["attempted"],
                              out["failed"], out["metrics"], info,
                              out["checks"], out["extra"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
