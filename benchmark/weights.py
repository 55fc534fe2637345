"""The model's initial weights, made by the benchmark on the device from
the run's seed, in the program's nested layout: every matrix a truncated
normal (+-2 sigma, then scaled by ``initializer_range``) drawn in one
call, biases 0, LayerNorm scales 1. Both the program and the reference
start from these tensors."""

import math

import torch


def shapes(cfg: dict) -> dict:
    """``{path: (shape, kind)}``, kind ``normal``, ``zeros`` or ``ones``."""
    h, n = cfg["hidden_size"], cfg["num_attention_heads"]
    d, f = h // n, cfg["inner_dim"]
    v, s = cfg["vocab_size"], cfg["max_sequence_length"]
    out = {"encoder/item_embeddings/embedding": ((v, h), "normal"),
           "encoder/position_embeddings/embedding": ((s, h), "normal"),
           "encoder/embedding_norm/scale": ((h,), "ones"),
           "encoder/embedding_norm/bias": ((h,), "zeros")}
    for i in range(cfg["num_layers"]):
        pre = f"encoder/layers/layer_{i}/"
        out.update({
            pre + "attention/qkv/kernel": ((h, 3, n, d), "normal"),
            pre + "attention/qkv/bias": ((3, n, d), "zeros"),
            pre + "attention/output/kernel": ((n, d, h), "normal"),
            pre + "attention/output/bias": ((h,), "zeros"),
            pre + "attention_norm/scale": ((h,), "ones"),
            pre + "attention_norm/bias": ((h,), "zeros"),
            pre + "intermediate/kernel": ((h, f), "normal"),
            pre + "intermediate/bias": ((f,), "zeros"),
            pre + "output/kernel": ((f, h), "normal"),
            pre + "output/bias": ((h,), "zeros"),
            pre + "output_norm/scale": ((h,), "ones"),
            pre + "output_norm/bias": ((h,), "zeros")})
    out.update({"encoder/pooler/kernel": ((h, h), "normal"),
                "encoder/pooler/bias": ((h,), "zeros"),
                "mlm/transform/kernel": ((h, h), "normal"),
                "mlm/transform/bias": ((h,), "zeros"),
                "mlm/transform_norm/scale": ((h,), "ones"),
                "mlm/transform_norm/bias": ((h,), "zeros"),
                "mlm/output_bias": ((v,), "zeros")})
    return out


def make(cfg: dict, seed: int, device) -> dict:
    """Flat ``{path: float32 tensor}`` on ``device`` from ``seed``."""
    layout = shapes(cfg)
    normal = [k for k, (_, kind) in layout.items() if kind == "normal"]
    sizes = [math.prod(layout[k][0]) for k in normal]
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=gen)
    buf.mul_(cfg["initializer_range"])
    out = {k: t.view(layout[k][0])
           for k, t in zip(normal, buf.split(sizes))}
    for k, (shape, kind) in layout.items():
        if kind != "normal":
            out[k] = (torch.ones if kind == "ones" else torch.zeros)(
                shape, dtype=torch.float32, device=device)
    return out
