"""Run the quality harness on one CUDA card and count its kernel launches
by route:

    python bert4rec_tpu_torch/tools/count_launches.py --oracle \\
        --oracle-scale ml20m

takes the flags of ``python -m bert4rec_tpu_torch.tools.quality_run``,
sets every launch counter of the layer, loss and flash attention kernels
to 0, runs the harness, and prints one JSON line with the counters, the
harness's exit code and its wall seconds. It exits with the harness's
code.
"""

import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]

COUNTERS = {
    "fused_encoder_layer": (
        "launches", "backward_launches", "causal_launches",
        "causal_backward_launches", "rel_launches", "rel_backward_launches",
        "mma_sync_launches", "mma_sync_backward_launches", "tf32_launches",
        "tf32_backward_launches"),
    "fused_mlm_loss": ("launches", "backward_launches"),
    "fused_mlm_loss_tiled": ("launches", "merged_launches",
                             "two_sweep_launches"),
    "flash_attention": ("launches", "backward_launches", "tf32_launches",
                        "tf32_backward_launches", "simt_launches",
                        "simt_backward_launches"),
}


def counted_functions():
    import importlib
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    return {"fused_encoder_layer": fel.fused_encoder_layer,
            "fused_mlm_loss": fml.fused_mlm_loss,
            "fused_mlm_loss_tiled": fml.fused_mlm_loss_tiled,
            "flash_attention": fa.flash_attention}


def main(argv=None) -> int:
    sys.path.insert(0, str(REPO))
    from bert4rec_tpu_torch.evaluation import quality_harness
    fns = counted_functions()
    for name, attrs in COUNTERS.items():
        for attr in attrs:
            setattr(fns[name], attr, 0)
    t0 = time.perf_counter()
    rc = quality_harness.main(argv)
    wall = time.perf_counter() - t0
    print(json.dumps({
        "rc": rc, "wall_seconds": round(wall, 1),
        "launches": {f"{name}.{attr}": getattr(fns[name], attr)
                     for name, attrs in COUNTERS.items() for attr in attrs}}),
        flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
