"""What two checkouts' kernels compute and compile to, on one CUDA card,
without timing: the SASS of every kernel in a checkout's built libraries,
and the bits of the loss kernels' outputs on fixed inputs.

    python bert4rec_tpu_torch/tools/compare_builds.py --root A > a.json
    python bert4rec_tpu_torch/tools/compare_builds.py --root B > b.json
    python bert4rec_tpu_torch/tools/compare_builds.py --diff a.json b.json

``--root`` builds the checkout's kernels from its own sources and prints
one JSON line: ``sass``, a hash of each kernel's instructions (addresses,
the control half of each encoding, the dump's padding and the per-file
name of the anonymous namespace dropped), and
``bits``, a hash of the outputs of K3, K4, K5 (both entries), K6 and K7
in fp32 and of K3, K6 and K7 in bf16 at a few shapes (K6/K7 fed the plain
forward's lse, so that they see the same input in both checkouts), and of
the fp32 layer's served forward (K1: nothing saved, rate 0) at B=32 and
256, ml-1m_128's width, and of flash attention's K8 (o and the row
statistics) and K9 (dq, dk, dv) in both dtypes,
at rates 0 and 0.2, bidirectional and causal, on strided views of one
projection at FLASH_SHAPES, whatever route the checkout takes.
``--diff`` prints which kernels and outputs are the same in both."""

import argparse
import hashlib
import importlib
import json
import pathlib
import re
import subprocess
import sys

ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")
LOSS_SHAPES = ((2048, 3709, 128), (333, 1000, 72))            # K3, K4
TILED_SHAPES = ((2048, 26732, 128), (2048, 26732, 256), (333, 1000, 72))
FLASH_SHAPES = ((8, 12, 512, 64), (3, 4, 130, 64), (4, 2, 70, 32))    # K8, K9


def sass_hashes(build_dir: pathlib.Path) -> dict:
    """``{library:kernel: hash}`` of every kernel's SASS."""
    out = {}
    for so in sorted(build_dir.glob("lib*.so")):
        lib = re.sub(r"-[0-9a-f]+$", "", so.stem)[3:]
        text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(so)],
                              capture_output=True, text=True, check=True).stdout
        for block in text.split("Function : ")[1:]:
            name, _, body = block.partition("\n")
            # runs of spaces collapsed: cuobjdump pads every line to the
            # module's longest instruction, which a new kernel can change
            lines = [" ".join(re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).split())
                     for ln in body.splitlines()
                     if ln.strip() and not re.fullmatch(r"\s*/\* 0x[0-9a-f]+ \*/\s*", ln)]
            key = f"{lib}:{ANON.sub('ANON', name.strip())}"
            out[key] = hashlib.sha1("\n".join(lines).encode()).hexdigest()[:12]
    return out


def digest(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def output_hashes(torch, np, fml) -> dict:
    device = torch.device("cuda")

    def operands(rows, v, w, dtype):
        rng = np.random.default_rng(rows + v + w)
        hidden = torch.from_numpy(rng.normal(size=(rows, w)).astype(np.float32))
        table = torch.from_numpy((rng.normal(size=(v, w)) * 0.1).astype(np.float32))
        bias = torch.from_numpy(rng.normal(size=v).astype(np.float32))
        lab = rng.integers(0, v + 5, size=rows).astype(np.int32)
        lab[::9] = 0
        return (hidden.to(device, dtype), table.to(device, dtype), bias.to(device),
                torch.from_numpy(lab).to(device))

    g = torch.full((), 0.75, device=device)
    out = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for shape in LOSS_SHAPES:
            h, t, b, lab = operands(*shape, dtype)
            lse, sums = fml._launch_forward(h, t, b, lab)
            out[f"{name} K3 {shape}"] = digest(lse, sums)
            if dtype == torch.float32:
                out[f"{name} K4 {shape}"] = digest(*fml._launch_backward(
                    h, t, b, lab, lse, g, sums[3:4]))
        for shape in TILED_SHAPES:
            h, t, b, lab = operands(*shape, dtype)
            if dtype == torch.float32:
                out[f"{name} K5 {shape}"] = digest(
                    *fml._launch_forward_tiled(h, t, b, lab))
                out[f"{name} K5 stats {shape}"] = digest(
                    *fml._launch_forward_tiled_stats(h, t, b, lab))
            lse, sums = fml.fused_mlm_loss_plain_forward(h, t, b, lab)
            for kernel, merged in (("K6", True), ("K7", False)):
                out[f"{name} {kernel} {shape}"] = digest(*fml._launch_backward_tiled(
                    h, t, b, lab, lse, g, sums[3:4], merged))
    torch.cuda.synchronize()
    return out


def layer_hashes(torch, np, fel) -> dict:
    """The fp32 served layer's output bits at ml-1m_128's width (H=128, 4
    heads, F=512, S=200), right-padded rows, B=32 and 256."""
    from bert4rec_tpu_torch.utils.checkpoint import params_from_numpy
    device = torch.device("cuda")
    rng = np.random.default_rng(128)
    h, n, f, s, b = 128, 4, 512, 200, 256

    def w(*shape, scale=0.05):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    flat = fel.flat_weights(params_from_numpy({
        "attention/qkv/kernel": w(h, 3, n, h // n, scale=0.1),
        "attention/qkv/bias": w(3, n, h // n, scale=0.02),
        "attention/output/kernel": w(n, h // n, h),
        "attention/output/bias": w(h, scale=0.02),
        "attention_norm/scale": 1.0 + w(h, scale=0.1),
        "attention_norm/bias": w(h, scale=0.02),
        "intermediate/kernel": w(h, f), "intermediate/bias": w(f, scale=0.02),
        "output/kernel": w(f, h), "output/bias": w(h, scale=0.02),
        "output_norm/scale": 1.0 + w(h, scale=0.1),
        "output_norm/bias": w(h, scale=0.02)}, device))
    x = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32)).to(device)
    lengths = rng.integers(1, s + 1, size=b)
    mask = torch.from_numpy((np.arange(s)[None, :] < lengths[:, None])
                            .astype(np.int32)).to(device)
    out = {f"fp32 K1 served B={bb}": digest(fel._launch_forward(
        flat, x[:bb], mask[:bb], n, 0, 0.0, 0.0, False)[0]) for bb in (32, b)}
    torch.cuda.synchronize()
    return out


def flash_hashes(torch, np, fa) -> dict:
    """K8's and K9's output bits on q, k, v as views of one [B, S, 3, N, D]
    projection, a mask with a full row, a length-1 row and an all-pad row,
    the rest random right-padded lengths."""
    device = torch.device("cuda")
    out = {}
    for dims in FLASH_SHAPES:
        b, n, s, d = dims
        rng = np.random.default_rng(sum(dims))
        proj = torch.from_numpy(rng.normal(size=(b, s, 3, n, d))
                                .astype(np.float32)).to(device)
        do = torch.from_numpy(rng.normal(size=(b, n, s, d))
                              .astype(np.float32)).to(device)
        lengths = rng.integers(1, s + 1, size=b)
        lengths[:3] = [s, 1, 0]
        mask = torch.from_numpy((np.arange(s)[None, :] < lengths[:, None])
                                .astype(np.int32)).to(device)
        for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = (proj.to(dtype)[:, :, i].transpose(1, 2) for i in range(3))
            for rate in (0.0, 0.2):
                for causal in (False, True):
                    key = (f"{name} flash {dims} rate {rate} "
                           f"{'causal' if causal else 'bidirectional'}")
                    o, saved = fa._launch_forward(q, k, v, mask, 5, rate, causal,
                                                  True)
                    grads = fa._launch_backward(q, k, v, mask, do.to(dtype), saved,
                                                5, rate, causal)
                    # the row statistics (bf16's keep bits are K9's input,
                    # and a causal launch leaves some of them unwritten)
                    out[f"{key} K8"] = digest(o, *saved[:2])
                    out[f"{key} K9"] = digest(*grads)
    torch.cuda.synchronize()
    return out


def diff(a_path, b_path) -> None:
    a, b = (json.loads(pathlib.Path(p).read_text()) for p in (a_path, b_path))
    for part in ("sass", "bits"):
        x, y = a[part], b[part]
        same = [k for k in x if y.get(k) == x[k]]
        other = [k for k in x if k in y and y[k] != x[k]]
        print(f"{part}: {len(same)} the same, {len(other)} differ, "
              f"{len(set(x) - set(y))} only in {a['root']}, "
              f"{len(set(y) - set(x))} only in {b['root']}")
        for k in other:
            print(f"  differs: {k}")
        for k in sorted(set(x) - set(y)):
            print(f"  only in {a['root']}: {k}")
        for k in sorted(set(y) - set(x)):
            print(f"  only in {b['root']}: {k}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root")
    parser.add_argument("--diff", nargs=2)
    args = parser.parse_args(argv)
    if args.diff:
        diff(*args.diff)
        return 0
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("compare_builds: no CUDA device", file=sys.stderr)
        return 1
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    from bert4rec_tpu_torch.ops import kernel_build
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    if not fml.__file__.startswith(str(root)):
        raise RuntimeError(f"imported {fml.__file__}, not from {root}")
    kernel_build.build(kernel_build.kernel_sources())
    print(json.dumps({"root": args.root,
                      "sass": sass_hashes(kernel_build.BUILD_DIR),
                      "bits": {**output_hashes(torch, np, fml),
                               **layer_hashes(torch, np, fel),
                               **flash_hashes(torch, np, fa)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
