"""The training comparison: the reference follows the program's first
three steps from the same weights and batches, and three numbers are read.

- ``loss``: the widest relative gap of a step's loss;
- ``grad``: the first clipped gradient, by its worst leaf: ``|‖g_prog‖ -
  ‖g_ref‖| / max(‖g_ref‖, median leaf's ‖g_ref‖)``; the program's is
  ``mu / (1 - b1)`` of its optimizer state after one step;
- ``change``: the parameters' change after three steps, by its worst
  leaf, the same way, over the leaves whose first reference gradient is
  at least a thousandth of the median leaf's (a leaf the loss does not
  reach moves by weight decay and round-off alone).
"""

import statistics

import torch

from benchmark.reference import laws, model


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def route_of(cfg: dict, device) -> str:
    """The encoder layer the configuration states on this device: the
    fused layer runs with dropout only on the card."""
    return ("fused" if cfg.get("use_fused_layer")
            and torch.device(device).type == "cuda" else "block")


def follow(init: dict, batches: list, cfg: dict, opt: dict, seed: int,
           device, mm=torch.matmul, half=False) -> dict:
    """The reference's readings over ``batches``: per-step losses, the
    first clipped gradient's leaf norms and the three steps' change."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p0 = {k: v.to(device, torch.float32) for k, v in init.items()}
    flat = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    state = {"count": 0,
             "mu": {k: torch.zeros_like(v) for k, v in p0.items()},
             "nu": {k: torch.zeros_like(v) for k, v in p0.items()}}
    route = route_of(cfg, device)
    losses, grad = [], None
    for step, host in enumerate(batches):
        batch = {k: v.to(device) for k, v in host.items()}
        rows = (torch.arange(batch["input_word_ids"].shape[0] // 2,
                             device=device) if half else None)
        value = model.loss(unflatten(flat), batch, cfg,
                           laws.fold_in(seed, step), route, mm, rows)
        got = torch.autograd.grad(value, list(flat.values()),
                                  allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g.detach()
                 for (k, p), g in zip(flat.items(), got)}
        clipped = laws.adamw({k: v.data for k, v in flat.items()}, grads,
                             state, opt)
        if grad is None:
            grad = {k: float(g.norm()) for k, g in clipped.items()}
        losses.append(float(value.detach()))
    change = {k: float((flat[k].detach() - p0[k]).norm()) for k in flat}
    return {"losses": losses, "grad": grad, "change": change}


def worst_leaf(prog: dict, ref: dict, leaves) -> float:
    leaves = list(leaves)
    median = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
               for k in leaves)


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers of the program's readings against the
    reference's (both ``follow``'s layout)."""
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(prog["losses"], ref["losses"]))
    median = statistics.median(ref["grad"].values())
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * median]
    return {"loss": loss,
            "grad": worst_leaf(prog["grad"], ref["grad"], ref["grad"]),
            "change": worst_leaf(prog["change"], ref["change"], moved)}
