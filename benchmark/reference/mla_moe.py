"""Next-item training of DeepSeek-V3's decoder block (``deepseek_v3``, as
Moonlight-16B-A3B publishes it) in plain float32 PyTorch: the forward,
the loss and, through autograd, the gradients of the whole model, and the
clipped AdamW step. No kernel, nothing of the program under test or of
JAX; TF32 off (``follow``). The port's CPU tests import it through
``tests/reference_mla_moe.py``.

The model (``cfg`` a config dict; ``x`` the residual stream, ``N`` heads):

    x   = item_table[ids]                     (no position table, no norm)
    per layer:
      h   = RMSNorm(x)                        (eps rms_norm_eps, weight only)
      q   = h W_q -> [N, nope + rope] = [q_nope | q_pe]       (no q-LoRA)
      c   = h W_kv_down -> [rank | k_pe];  c_kv = RMSNorm(c[:rank])
      kv  = c_kv W_kv_up -> [N, nope + v] = [k_nope | v]
      q_pe, k_pe <- RoPE(rope_theta) on pairs (2i, 2i+1) at the position;
                    k_pe one head, shared by the N
      o   = softmax(q k^T / sqrt(nope + rope) + pad bias + causal bias) v
      x  += o W_o
      h2  = RMSNorm(x)
      dense layer (i < first_k_dense_replace): x += W_d(silu(h2 W_g) * h2 W_u)
      MoE layer: s = sigmoid(h2 W_r^T); sel = top-k(s + b);
                 w = s[sel] / (sum s[sel] + 1e-20) * routed_scaling_factor;
                 x += sum_j w_j E_sel_j(h2) + Shared(h2)   (SwiGLU experts)
    x = RMSNorm(x); the item head at the predicted positions: dense, exact
    gelu, LayerNorm (eps 1e-12), the item table (tied), an output bias;
    the mean cross-entropy over the positions whose label is not 0.

The biases are -1e9 each: a key past the row's length, and a key after
its query (added, as the program's attention adds them). Each token's
routed output is the weighted sum of its own selected experts' outputs,
computed expert by expert over the tokens that selected it.

Departures from the source's ``modeling_deepseek.py``: the item head in
place of an untied ``lm_head``; no position table (as the source); ``b``
(``e_score_correction_bias``) a fixed draw (``selection_bias``) with no
update rule and no auxiliary balance loss; dropout 0 (as published).

Routing is judged, then followed. The program's bf16 router input moves
near-ties between the k-th and (k+1)-th scores, so the reference never
compares its own choice with the program's: it computes its own scores,
judges each expert the program selected (``judge``: its biased score must
reach the reference's k-th best biased score less ``epsilon``), and then
follows the program's selection, so that the loss, gradient and change
measure arithmetic and not tie-breaking.
"""

import math

import torch
import torch.nn.functional as F

NEG = -1e9
LN_EPS = 1e-12
# The judge's epsilon, in units of the router score's rounding (``unit``:
# sigma'(z) times the root-sum-square of the router product's terms times
# 2^-8, the bf16 rounding of the router's input, 2^-9 relative, doubled for
# the error the program's upstream layers carry into it), times this count.
# At Moonlight's widths on an H100 the program's bf16 selections fell at
# most 20.4 units short over ten runs of 921,600 selections (none past
# 32), while a selection without the bias falls past 32 units some 4,000
# times a run and top-5 and a random expert past 128 some 133,000 times
# (PERF.md §6).
EPS_UNITS = 48.0
# the judge's tally: selections past each of these many units
JUDGE_EDGES = (1, 2, 4, 8, 16, 32, 64, 128)


def selection_bias(cfg: dict, device) -> torch.Tensor:
    """``b`` ``[n_moe_layers, E]``: a standard normal drawn on the CPU from
    a generator seeded ``router_bias_seed`` mod 2^63, times
    ``router_bias_std``."""
    n = max(cfg["num_layers"] - cfg["first_k_dense_replace"], 0)
    gen = torch.Generator().manual_seed(cfg["router_bias_seed"] % (2 ** 63))
    b = torch.randn((n, cfg["n_routed_experts"]), generator=gen,
                    dtype=torch.float32)
    return (b * cfg["router_bias_std"]).to(device)


def shapes(cfg: dict) -> dict:
    """``{path: (shape, kind)}`` of the model's parameters in the
    program's layout, kind ``normal``, ``zeros`` or ``ones``."""
    h, n, v = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["vocab_size"]
    nope, rope_d, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], \
        cfg["v_head_dim"]
    r, e, i = cfg["kv_lora_rank"], cfg["n_routed_experts"], \
        cfg["moe_intermediate_size"]
    out = {"encoder/item_embeddings/embedding": ((v, h), "normal")}
    for layer in range(cfg["num_layers"]):
        pre = f"encoder/layers/layer_{layer}/"
        out.update({
            pre + "attention_norm/scale": ((h,), "ones"),
            pre + "attention/query/kernel": ((h, n, nope + rope_d), "normal"),
            pre + "attention/kv_down/kernel": ((h, r + rope_d), "normal"),
            pre + "attention/kv_norm/scale": ((r,), "ones"),
            pre + "attention/kv_up/kernel": ((r, n, nope + dv), "normal"),
            pre + "attention/output/kernel": ((n, dv, h), "normal"),
            pre + "ffn_norm/scale": ((h,), "ones")})
        if layer < cfg["first_k_dense_replace"]:
            f = cfg["inner_dim"]
            out.update({pre + "mlp/gate/kernel": ((h, f), "normal"),
                        pre + "mlp/up/kernel": ((h, f), "normal"),
                        pre + "mlp/down/kernel": ((f, h), "normal")})
        else:
            sh = cfg["n_shared_experts"] * i
            out.update({
                pre + "moe/router/kernel": ((e, h), "normal"),
                pre + "moe/experts/gate": ((e, h, i), "normal"),
                pre + "moe/experts/up": ((e, h, i), "normal"),
                pre + "moe/experts/down": ((e, i, h), "normal"),
                pre + "moe/shared/gate/kernel": ((h, sh), "normal"),
                pre + "moe/shared/up/kernel": ((h, sh), "normal"),
                pre + "moe/shared/down/kernel": ((sh, h), "normal")})
    out.update({"encoder/final_norm/scale": ((h,), "ones"),
                "mlm/transform/kernel": ((h, h), "normal"),
                "mlm/transform/bias": ((h,), "zeros"),
                "mlm/transform_norm/scale": ((h,), "ones"),
                "mlm/transform_norm/bias": ((h,), "zeros"),
                "mlm/output_bias": ((v,), "zeros")})
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Flat ``{path: float32 tensor}`` on ``device`` from ``seed``: every
    matrix a normal cut at +-2 sigma and scaled by ``initializer_range``,
    drawn in one call in ``shapes``' order; norms' scales 1, biases 0."""
    layout = shapes(cfg)
    normal = [k for k, (_, kind) in layout.items() if kind == "normal"]
    sizes = [math.prod(layout[k][0]) for k in normal]
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=gen)
    buf.mul_(cfg["initializer_range"])
    out = {k: t.view(layout[k][0]) for k, t in zip(normal, buf.split(sizes))}
    for k, (shape, kind) in layout.items():
        if kind != "normal":
            out[k] = (torch.ones if kind == "ones" else torch.zeros)(
                shape, dtype=torch.float32, device=device)
    return out


# --------------------------------------------------------------------------- #
# the layers (every product through ``mm``)
# --------------------------------------------------------------------------- #

def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def layer_norm(x, p):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * p["scale"] + p["bias"]


def rope(x, theta):
    """Rotate the pairs (2i, 2i+1) of ``x [B, S, heads, d]`` by ``pos *
    theta^(-2i / d)``."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    c, sn = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.stack([even * c - odd * sn, even * sn + odd * c],
                       dim=-1).flatten(-2)


def mla(p, x, mask, cfg, mm=torch.matmul):
    """The attention sublayer's output (before the residual add) of the
    normed stream ``x [B, S, H]``; ``mask [B, S]`` 1 for real tokens."""
    b, s, h = x.shape
    n = cfg["num_attention_heads"]
    nope, rd, dv, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], \
        cfg["v_head_dim"], cfg["kv_lora_rank"]
    flat = x.reshape(b * s, h)
    q = mm(flat, p["query"]["kernel"].reshape(h, -1)).view(b, s, n, -1)
    c = mm(flat, p["kv_down"]["kernel"]).view(b, s, r + rd)
    c_kv = rms_norm(c[..., :r], p["kv_norm"]["scale"], cfg["rms_norm_eps"])
    kv = mm(c_kv.reshape(b * s, r),
            p["kv_up"]["kernel"].reshape(r, -1)).view(b, s, n, nope + dv)
    theta = cfg["rope_theta"]
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], -1)
    k_pe = rope(c[..., r:][:, :, None, :], theta).expand(b, s, n, rd)
    k = torch.cat([kv[..., :nope], k_pe], -1)
    v = kv[..., nope:]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bias = torch.where(mask > 0, 0.0, NEG)[:, None, None, :]
    if cfg.get("causal_attention", True):
        bias = bias + torch.triu(torch.full((s, s), NEG, device=x.device),
                                 diagonal=1)
    scores = mm(qt, kt.transpose(-1, -2)) / math.sqrt(nope + rd) + bias
    o = mm(torch.softmax(scores, -1), vt).transpose(1, 2)
    return mm(o.reshape(b * s, n * dv),
              p["output"]["kernel"].reshape(n * dv, h)).view(b, s, h)


def swiglu(x, wg, wu, wd, mm=torch.matmul):
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def router_scores(p, x, mm=torch.matmul):
    """``sigmoid(x W_r^T)`` ``[T, E]`` of the rows ``x [T, H]``."""
    return torch.sigmoid(mm(x, p["router"]["kernel"].T))


def unit(p, x):
    """The router scores' rounding unit ``[T, E]`` of the rows ``x``
    (``EPS_UNITS``)."""
    w = p["router"]["kernel"]
    sig = torch.sigmoid(x @ w.T)
    return 2.0 ** -8 * sig * (1.0 - sig) * torch.sqrt(x.square()
                                                     @ w.square().T)


def judge(scores, bias, sel, units, k) -> torch.Tensor:
    """How far each of the program's selections ``sel [T, k]`` falls below
    the reference's k-th best biased score, in its expert's ``units``; a
    selection past ``EPS_UNITS`` is rejected."""
    biased = scores + bias
    kth = torch.topk(biased, k, dim=-1).values[:, -1:]
    return ((kth - biased.gather(1, sel)) / units.gather(1, sel)).flatten()


def tally(deficits: torch.Tensor) -> dict:
    """The judge's readings over ``deficits`` (``judge``'s, concatenated):
    the rejections, the largest and the count past each of
    ``JUDGE_EDGES``."""
    if not deficits.numel():
        return {"rejected": 0, "max": None, "past": {}}
    return {"rejected": int((deficits > EPS_UNITS).sum()),
            "max": float(deficits.max()),
            "past": {str(e): int((deficits > e).sum()) for e in JUDGE_EDGES}}


def routed_experts(p, x, sel, w, mm=torch.matmul):
    """``sum_j w[t, j] E_sel[t, j](x[t])`` ``[T, H]``: each expert over the
    tokens that selected it, every token's slots summed in slot order."""
    t, k = sel.shape
    ex = p["experts"]
    slots = x.new_zeros((t, k, x.shape[-1]))
    for e in range(ex["gate"].shape[0]):
        tok, slot = (sel == e).nonzero(as_tuple=True)
        if tok.numel():
            slots[tok, slot] = swiglu(x[tok], ex["gate"][e], ex["up"][e],
                                      ex["down"][e], mm)
    return (slots * w[..., None]).sum(1)


def moe(p, x, bias, sel, cfg, mm=torch.matmul, found=None, chosen=None):
    """The MoE sublayer's output of the normed rows ``x [T, H]``. ``sel``
    the program's selection to follow (None: the reference's own, appended
    to ``chosen`` when that is a list); with ``found`` (a list) the judge's
    rejections are appended to it."""
    scores = router_scores(p, x, mm)
    k = cfg["num_experts_per_tok"]
    if sel is None:
        sel = torch.topk(scores + bias, k, dim=-1).indices
        if chosen is not None:
            chosen.append(sel)
    elif found is not None:
        with torch.no_grad():
            found.append(judge(scores, bias, sel, unit(p, x), k).cpu())
    w = scores.gather(1, sel)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    sh = p["shared"]
    return routed_experts(p, x, sel, w, mm) + swiglu(
        x, sh["gate"]["kernel"], sh["up"]["kernel"], sh["down"]["kernel"],
        mm)


def encode(params, ids, mask, cfg, selections=None, mm=torch.matmul,
           found=None, chosen=None):
    """The final-normed stream ``[B, S, H]``. ``selections``: per MoE
    layer the program's ``[B, S, k]`` selection to judge and follow (None:
    the reference's own, each layer's appended to ``chosen``)."""
    enc = params["encoder"]
    x = enc["item_embeddings"]["embedding"][ids.long()]
    b, s, h = x.shape
    eps = cfg["rms_norm_eps"]
    bias = selection_bias(cfg, x.device)
    for i in range(cfg["num_layers"]):
        p = enc["layers"][f"layer_{i}"]
        x = x + mla(p["attention"], rms_norm(x, p["attention_norm"]["scale"],
                                             eps), mask, cfg, mm)
        h2 = rms_norm(x, p["ffn_norm"]["scale"], eps)
        if "mlp" in p:
            m = p["mlp"]
            x = x + swiglu(h2, m["gate"]["kernel"], m["up"]["kernel"],
                           m["down"]["kernel"], mm)
            continue
        j = i - cfg["first_k_dense_replace"]
        sel = None if selections is None else \
            selections[j].reshape(b * s, -1).long()
        x = x + moe(p["moe"], h2.reshape(b * s, h), bias[j], sel, cfg, mm,
                    found, chosen).view(b, s, h)
    return rms_norm(x, enc["final_norm"]["scale"], eps)


def logits(params, x, pos, mm=torch.matmul):
    """The item head over the positions ``pos [B, P]``: ``[B, P, V]``."""
    hid = torch.gather(x, 1, pos.long()[..., None].expand(-1, -1,
                                                           x.shape[-1]))
    mlm = params["mlm"]
    hid = F.gelu(mm(hid, mlm["transform"]["kernel"])
                 + mlm["transform"]["bias"], approximate="none")
    hid = layer_norm(hid, mlm["transform_norm"])
    return mm(hid, params["encoder"]["item_embeddings"]["embedding"].T) \
        + mlm["output_bias"]


def nll_sum(params, batch, cfg, selections=None, mm=torch.matmul,
            found=None, chosen=None):
    """``(sum of the cross-entropy over labelled positions, their
    count)`` of a batch (or a block of its rows)."""
    x = encode(params, batch["input_word_ids"], batch["input_mask"], cfg,
               selections, mm, found, chosen)
    labels = batch["masked_lm_ids"].long()
    nll = -torch.log_softmax(logits(params, x, batch["masked_lm_positions"],
                                    mm), -1).gather(-1, labels[..., None])
    valid = (labels != 0).to(nll.dtype)
    return (nll[..., 0] * valid).sum(), valid.sum()


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #

def nest(flat: dict) -> dict:
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def learning_rate(opt: dict, n: int) -> float:
    """Update ``n``'s rate (from 0): a linear warm-up over ``warmup``, then
    a linear decay to 0 at ``train_steps``."""
    if n < opt["warmup"]:
        return opt["lr"] * n / max(1.0, opt["warmup"])
    return opt["lr"] * (1.0 - min(max(n / opt["train_steps"], 0.0), 1.0))


@torch.no_grad()
def adamw(flat: dict, state: dict, opt: dict) -> dict:
    """One update of the leaves of ``flat`` in place from their ``.grad``:
    the global-norm clip at ``clip`` (``g * clip / ||g||`` where ``||g||
    >= clip``), then AdamW (bias correction by the count after the update,
    decay on every path matching none of ``exclude``). Returns each leaf's
    clipped gradient norm."""
    import re
    norm = math.sqrt(sum(float(p.grad.double().square().sum())
                         for p in flat.values()))
    scale = 1.0 if norm < opt["clip"] else opt["clip"] / norm
    count = state["count"] + 1
    lr = learning_rate(opt, state["count"])
    bc1, bc2 = 1.0 - opt["b1"] ** count, 1.0 - opt["b2"] ** count
    norms = {}
    for k, p in flat.items():
        g = p.grad.mul_(scale)
        norms[k] = float(g.norm())
        mu = state["mu"].setdefault(k, torch.zeros_like(p))
        nu = state["nu"].setdefault(k, torch.zeros_like(p))
        mu.mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
        nu.mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
        upd = (mu / bc1) / ((nu / bc2).sqrt_() + opt["eps"])
        if opt["weight_decay"] and not any(re.search(x, k)
                                           for x in opt["exclude"]):
            upd.add_(p, alpha=opt["weight_decay"])
        p.sub_(lr * upd)
        p.grad = None
    state["count"] = count
    return norms


def follow(init: dict, batches: list, selections: list, cfg: dict,
           opt: dict, device, mm=torch.matmul, half=False,
           block_rows=None) -> dict:
    """The reference's readings over ``batches`` (host dicts of tensors)
    from the flat weights ``init``, following the program's
    ``selections`` (per step, per MoE layer ``[B, S, k]``; None: its own
    choice, returned as ``selections``): per-step losses, the first
    clipped gradient's leaf norms, each leaf's change after the last step,
    ``unsound``, the judge's rejections, and ``judge``, its ``tally``. ``half`` keeps the first half of every batch's rows (the
    half-batch fault); ``block_rows`` runs the rows in blocks of that many,
    each block's loss over the whole batch's count (the same sum)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flat = {k: v.to(device, torch.float32).clone().requires_grad_(True)
            for k, v in init.items()}
    params = nest(flat)
    state = {"count": 0, "mu": {}, "nu": {}}
    losses, grad, found, own = [], None, [], []
    for step, host in enumerate(batches):
        rows = host["input_word_ids"].shape[0] // (2 if half else 1)
        sel = None if selections is None else selections[step]
        count = float((host["masked_lm_ids"][:rows] != 0).sum())
        block = block_rows or rows
        total, blocks = 0.0, []
        for r0 in range(0, rows, block):
            r1 = min(r0 + block, rows)
            batch = {k: v[r0:r1].to(device) for k, v in host.items()}
            part = None if sel is None else [
                s[r0:r1].to(device) for s in sel]
            blocks.append([])
            value, _ = nll_sum(params, batch, cfg, part, mm, found,
                               blocks[-1])
            (value / max(count, 1.0)).backward()
            total += float(value.detach())
        losses.append(total / max(count, 1.0))
        if sel is None:
            shape = tuple(host["input_word_ids"][:rows].shape) + (-1,)
            own.append([torch.cat(layer).view(shape).cpu()
                        for layer in zip(*blocks)])
        norms = adamw(flat, state, opt)
        grad = grad or norms
    change = {k: float((p.detach().cpu() - init[k].cpu()).norm())
              for k, p in flat.items()}
    judged = tally(torch.cat(found) if found else torch.zeros(0))
    return {"losses": losses, "grad": grad, "change": change,
            "unsound": judged["rejected"], "judge": judged,
            "selections": selections or own}
