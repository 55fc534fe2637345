"""Start the ranks of a ``(data, model)`` mesh and run named checks in each.

    python -m bert4rec_tpu_torch.tools.mesh_run --data 2 --model 2 \\
        --device cpu --out DIR path/to/file.py:fn [module:fn ...]

The launcher starts ``data * model`` processes on this machine (gloo, or
NCCL where every rank gets its own GPU: ``core.mesh.choose_backend``),
joined at ``localhost`` on a free port. Each rank builds its mesh and calls
every check ``fn(mesh, out_dir, **kwargs)`` in turn (``--kwargs`` a JSON
object, the same for every check); a check returns a dict of
arrays and numbers, written to ``DIR/<fn>.rank<r>.npz``, and each rank
writes ``DIR/rank<r>.json`` (its coordinates, device, backend and each
check's seconds). The launcher waits for every rank, stops them all when
one fails or the time limit passes, and then exits with 1, the ranks'
output on standard error. :func:`launch` and :func:`load` are the same
from Python.
"""

import argparse
import importlib
import importlib.util
import json
import os
import pathlib
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _resolve(check: str):
    """``path/to/file.py:fn`` or ``package.module:fn`` -> the function."""
    where, name = check.rsplit(":", 1)
    if where.endswith(".py"):
        path = pathlib.Path(where)
        spec = importlib.util.spec_from_file_location(
            f"_mesh_check_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _save(path: pathlib.Path, result) -> None:
    arrays = {}
    for k, v in (result or {}).items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        arrays[k] = np.asarray(v)
    np.savez(path, **arrays)


def _worker(args) -> None:
    import torch

    from bert4rec_tpu_torch.core import mesh as mesh_lib

    torch.set_num_threads(1)   # ranks share this machine's cores
    mesh_lib.distributed_initialize(f"localhost:{args.port}",
                                    args.data * args.model, args.rank,
                                    device=args.device,
                                    timeout_s=args.timeout)
    mesh = mesh_lib.create_mesh(mesh_lib.MeshConfig(
        model_parallelism=args.model, data_parallelism=args.data))
    out = pathlib.Path(args.out)
    record = {"rank": args.rank, "coords": mesh.coords,
              "device": str(mesh.device), "backend": mesh.backend,
              "seconds": {}}
    for check in args.checks:
        fn = _resolve(check)
        t0 = time.time()
        result = fn(mesh, out, **json.loads(args.kwargs))
        record["seconds"][fn.__name__] = time.time() - t0
        _save(out / f"{fn.__name__}.rank{args.rank}.npz", result)
    (out / f"rank{args.rank}.json").write_text(json.dumps(record))
    torch.distributed.destroy_process_group()


def launch(checks: Sequence[str], data: int = 1, model: int = 1,
           device: str = "cpu", out=None, timeout: float = 600.0,
           kwargs: Optional[dict] = None) -> List[dict]:
    """Run ``checks`` on every rank of a ``(data, model)`` mesh; returns
    the ranks' JSON records in rank order. Raises RuntimeError (with the
    failing rank's output) when a rank fails or the time runs out."""
    out = pathlib.Path(out)
    out.mkdir(parents=True, exist_ok=True)
    world = data * model
    port = free_port()
    cmd = [sys.executable, "-m", "bert4rec_tpu_torch.tools.mesh_run",
           "--worker", "--port", str(port), "--data", str(data),
           "--model", str(model), "--device", device, "--out", str(out),
           "--timeout", str(timeout), "--kwargs", json.dumps(kwargs or {})]
    run_env = dict(os.environ)
    run_env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in run_env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    procs = []
    for rank in range(world):
        log = open(out / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            cmd + ["--rank", str(rank), *checks], stdout=log,
            stderr=subprocess.STDOUT, env=run_env, cwd=str(ROOT)), log))
    deadline = time.time() + timeout
    failed = None
    try:
        while any(p.poll() is None for p, _ in procs):
            bad = [(r, p.returncode) for r, (p, _) in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad or time.time() > deadline:
                failed = bad[0] if bad else (None, "timeout")
                break
            time.sleep(0.05)
        if failed is None:
            bad = [(r, p.returncode) for r, (p, _) in enumerate(procs)
                   if p.returncode != 0]
            failed = bad[0] if bad else None
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed is not None:
        rank, code = failed
        logs = "\n".join(
            f"--- rank {r} ---\n"
            + (out / f"rank{r}.log").read_text()[-4000:]
            for r in range(world))
        raise RuntimeError(f"mesh ({data}, {model}) rank {rank} failed "
                           f"({code}):\n{logs}")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)]


def load(out, check: str, world: int) -> List[dict]:
    """The arrays each rank's ``check`` returned, in rank order."""
    name = check.rsplit(":", 1)[-1]
    out = pathlib.Path(out)
    result = []
    for r in range(world):
        with np.load(out / f"{name}.rank{r}.npz") as f:
            result.append(dict(f))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checks", nargs="+")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--kwargs", default="{}")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args)
        return 0
    try:
        records = launch(args.checks, args.data, args.model, args.device,
                         args.out, args.timeout,
                         kwargs=json.loads(args.kwargs))
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 1
    for rec in records:
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
