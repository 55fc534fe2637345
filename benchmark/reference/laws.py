"""Laws the configuration states, written out for the reference.

- Dropout on the fused layer's sites and on flash attention's
  probabilities: a 32-bit counter hash (murmur3's finaliser), kept where
  ``fmix32(fmix32(key) ^ counter * 0x9E3779B9) >= uint32(rate * 2^32)``
  with ``key = seed + elem * 64 + site`` and ``counter = row * cols +
  col``; site ``h`` is head ``h``'s probabilities, ``N`` the attention
  output and ``N + 1`` the FFN output.
- Other dropout (the embeddings, the unfused block's sublayer outputs and
  its plain attention): ``torch.rand(shape, generator=Generator(device)
  .manual_seed(seed)) < 1 - rate``.
- Seeds: step ``k`` of a run seeded ``s`` draws from ``fold_in(s, k)``;
  the embeddings from ``fold_in(step, 0)``, layer ``i`` from
  ``fold_in(step, 1 + i)``, and an unfused block's three sites from
  ``fold_in(layer, 0..2)``. ``fold_in(a, b) = hash(a, b) & 0x7FFFFFFF``.
- The optimizer: global-norm clip at ``clip`` (``g * clip / ||g||`` where
  ``||g|| >= clip``), then AdamW with bias correction by the count after
  the update, decay on every path matching none of ``exclude``, and the
  learning rate of update ``n`` (from 0) a linear warm-up over ``warmup``
  updates then a linear decay to 0 at ``train_steps``, in float32.
"""

import re

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
SITES = 64


def _mul32(a, c):
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & MASK32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash32(key, counter):
    return _fmix32(_fmix32(key & MASK32) ^ _mul32(counter, 0x9E3779B9))


def fold_in(seed: int, data: int) -> int:
    return int(hash32(torch.tensor(int(seed) & MASK32),
                      torch.tensor(int(data) & MASK32))) & 0x7FFFFFFF


def hash_keep(seed: int, batch: int, sites, rows: int, cols: int,
              rate: float, device) -> torch.Tensor:
    """``[B, len(sites), rows, cols]`` float32 keep scales of the hash law."""
    elem = torch.arange(batch, dtype=torch.int64, device=device)
    site = torch.as_tensor(list(sites), dtype=torch.int64, device=device)
    key = int(seed) + elem[:, None] * SITES + site[None, :]
    counter = torch.arange(rows * cols, dtype=torch.int64,
                           device=device).view(rows, cols)
    kept = hash32(key[:, :, None, None], counter[None, None]) \
        >= min(int(rate * 2 ** 32), MASK32)
    return kept.to(torch.float32) / (1.0 - rate)


def rand_keep(seed: int, shape, rate: float, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kept = torch.rand(shape, generator=gen, device=device) < 1.0 - rate
    return kept.to(torch.float32) / (1.0 - rate)


def learning_rate(opt: dict, n: int) -> float:
    f32 = np.float32
    step = f32(n)
    if step < opt["warmup"]:
        return float(f32(opt["lr"]) * step / f32(max(1.0, opt["warmup"])))
    frac = np.clip(step / f32(opt["train_steps"]), f32(0.0), f32(1.0))
    return float(f32(opt["lr"]) * (f32(1.0) - frac))


def decays(opt: dict, path: str) -> bool:
    return not any(re.search(p, path) for p in opt["exclude"])


@torch.no_grad()
def adamw(params: dict, grads: dict, state: dict, opt: dict) -> dict:
    """One clipped AdamW update of the flat ``params`` in place; returns
    the clipped gradients."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    scale = 1.0 if norm < opt["clip"] else float(opt["clip"] / norm)
    clipped = {k: g * scale for k, g in grads.items()}
    count = state["count"] + 1
    f32 = np.float32
    bc1 = float(f32(1.0) - f32(opt["b1"]) ** f32(count))
    bc2 = float(f32(1.0) - f32(opt["b2"]) ** f32(count))
    lr = learning_rate(opt, state["count"])
    for k, p in params.items():
        g = clipped[k]
        mu = state["mu"][k].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
        nu = state["nu"][k].mul_(opt["b2"]).addcmul_(g, g,
                                                     value=1 - opt["b2"])
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + opt["eps"])
        if opt["weight_decay"] and decays(opt, k):
            upd = upd + opt["weight_decay"] * p
        p.sub_(lr * upd)
    state["count"] = count
    return clipped
