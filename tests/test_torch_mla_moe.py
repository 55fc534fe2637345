"""The ``mla_moe`` block (DeepSeek-V3's, as Moonlight-16B-A3B publishes it)
held to the plain float32 reference (``benchmark/reference/mla_moe.py``,
imported through ``tests/reference_mla_moe.py``) on
seeded random weights at a small size on the CPU: layer by layer (latent
attention with RoPE, the router, the routed and shared experts, the dense
layer), the whole model (loss, every gradient, one AdamW step), the routing
judge against planted faults, K11's plain version, the config and
checkpoint surface.

Tolerances. The port in fp32 and the reference compute the same products
in another order (einsum against matmul, fused against split sums): the
gaps measured at these sizes are <= 2e-6 relative (whole-model gradients
1.6e-6). Each limit below is 1e-5 (activations) or 1e-4 (gradients, summed
over every row), far above those and far below what the port gives in
bf16, the precision under the stated fp32: 3e-3 to 2e-2 (``*_bf16_fails``
tests hold that).
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bert4rec_tpu.models.config import BERT4RecConfig as JaxConfig
from bert4rec_tpu_torch.core.dtypes import DTypePolicy
from bert4rec_tpu_torch.models import (BERT4RecConfig, BERT4RecModel,
                                       BERT4RecModelWrapper, SASRecModel)
from bert4rec_tpu_torch.models.components import mla_moe as M
from bert4rec_tpu_torch.ops import expert_gemm as eg
from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers
from bert4rec_tpu_torch.utils import profiling
from bert4rec_tpu_torch.utils.checkpoint import flatten, unflatten

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import reference_mla_moe as R  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
ACT_TOL = 1e-5      # activations, relative to their norm (module docstring)
GRAD_TOL = 1e-4     # gradients, relative to their norm
B, S, V = 4, 16, 60


def config(**over) -> BERT4RecConfig:
    kw = dict(vocab_size=V, hidden_size=32, num_layers=3,
              num_attention_heads=2, inner_dim=64, max_sequence_length=S,
              max_predictions_per_seq=S - 1, block="mla_moe",
              output_dropout=0.0, attention_dropout=0.0,
              use_flash_attention=True, causal_attention=True,
              router_bias_seed=5)
    kw.update(over)
    return BERT4RecConfig(**kw)


def rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def batch_of(seed=0, lens=(16, 10, 5, 2)):
    """A next-item batch: rows of the given lengths, the last item taken
    out of the input, every remaining position labelled with its
    successor."""
    g = torch.Generator().manual_seed(seed)
    items = torch.randint(3, V, (B, S), generator=g)
    lens = torch.tensor(lens)
    n = lens - 1
    mask = (torch.arange(S)[None] < n[:, None]).int()
    pos = torch.arange(S - 1)[None].repeat(B, 1)
    valid = pos < n[:, None]
    return {"input_word_ids": (items * mask).int(), "input_mask": mask,
            "masked_lm_positions": (pos * valid).int(),
            "masked_lm_ids": (items[:, 1:] * valid).int()}


def weights(cfg, seed=3):
    return R.make_weights(cfg.to_dict(), seed, "cpu")


def layer_params(w, i):
    return unflatten(w)["encoder"]["layers"][f"layer_{i}"]


def stream(seed=1, shape=(B, S, 32)):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


# --------------------------------------------------------------------------- #
# layer by layer
# --------------------------------------------------------------------------- #

def _port_mla(cfg, p, x, dt):
    cos, sin = M.rope_tables(S, cfg.qk_rope_head_dim, cfg.rope_theta, "cpu")
    mask = batch_of()["input_mask"]
    return M.mla_attention(p, x.to(dt), mask, cos, sin, cfg, dt).float(), \
        mask


@pytest.mark.parametrize("causal", [True, False])
def test_mla_attention_with_rope_matches_reference(causal):
    cfg = config(causal_attention=causal)
    p = layer_params(weights(cfg), 0)["attention"]
    x = stream()
    got, mask = _port_mla(cfg, p, x, torch.float32)
    want = R.mla(p, x, mask, cfg.to_dict())
    assert rel(got, want) <= ACT_TOL


def test_mla_attention_in_bf16_fails_the_tolerance():
    cfg = config()
    p = layer_params(weights(cfg), 0)["attention"]
    x = stream()
    got, mask = _port_mla(cfg, p, x, torch.bfloat16)
    assert rel(got, R.mla(p, x, mask, cfg.to_dict())) > 10 * ACT_TOL


def test_rope_on_adjacent_pairs_is_the_sources_rotate_half():
    """The source de-interleaves q_pe and k_pe, then rotates halves; both
    are permuted alike, so every score q_pe . k_pe is the adjacent-pair
    rotation's."""
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn((2, S, 3, 64), generator=g) for _ in range(2))
    theta = 50000.0
    cos, sin = M.rope_tables(S, 64, theta, "cpu")
    ours = torch.einsum("bind,bjnd->bnij", M.rope(q, cos, sin),
                        M.rope(k, cos, sin))

    def source(x):
        b, s, n, d = x.shape
        x = x.view(b, s, n, d // 2, 2).transpose(4, 3).reshape(b, s, n, d)
        c = torch.cat([cos, cos], -1)[None, :, None, :]
        sn = torch.cat([sin, sin], -1)[None, :, None, :]
        half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
        return x * c + half * sn
    theirs = torch.einsum("bind,bjnd->bnij", source(q), source(k))
    assert rel(ours, theirs) <= 1e-6


def test_router_matches_reference():
    """The biased top-k picks the experts, the unbiased scores weigh them,
    normalised (+1e-20) and scaled by routed_scaling_factor."""
    cfg = config(router_bias_std=0.05)
    p = layer_params(weights(cfg), 1)["moe"]
    x = stream(2, (B * S, 32))
    bias = R.selection_bias(cfg.to_dict(), "cpu")[0]
    sel, w, scores = M.route(p, x, bias, cfg)
    want_scores = R.router_scores(p, x)
    assert rel(scores, want_scores) <= ACT_TOL
    want_sel = torch.topk(want_scores + bias, cfg.num_experts_per_tok,
                          dim=-1).indices
    assert torch.equal(sel.sort(-1).values, want_sel.sort(-1).values)
    ws = want_scores.gather(1, sel)
    want_w = ws / (ws.sum(-1, keepdim=True) + 1e-20) * 2.446
    assert rel(w, want_w) <= ACT_TOL
    assert w.sum(-1).sub(2.446).abs().max() <= 1e-5
    # the bias moves the choice here and is absent from the weights
    unbiased = torch.topk(want_scores, cfg.num_experts_per_tok, -1).indices
    assert not torch.equal(sel.sort(-1).values, unbiased.sort(-1).values)


def test_router_in_bf16_fails_the_tolerance():
    cfg = config()
    p = layer_params(weights(cfg), 1)["moe"]
    x = stream(2, (B * S, 32))
    lowered = {"router": {"kernel": p["router"]["kernel"].bfloat16()
                          .float()}}
    _, _, scores = M.route(lowered, x.bfloat16(), torch.zeros(64), cfg)
    assert rel(scores, R.router_scores(p, x)) > 10 * ACT_TOL


@pytest.mark.parametrize("dt, fails", [(torch.float32, False),
                                       (torch.bfloat16, True)])
def test_routed_and_shared_experts_match_reference(dt, fails):
    cfg = config()
    p = layer_params(weights(cfg), 1)["moe"]
    x = stream(4, (B, S, 32))
    bias = R.selection_bias(cfg.to_dict(), "cpu")[0]
    got = M.moe(p, x.to(dt), bias, cfg, dt).float()
    want = R.moe(p, x.reshape(B * S, 32), bias, None, cfg.to_dict())
    assert (rel(got.reshape(B * S, 32), want) > 10 * ACT_TOL) is fails


def test_dense_layer_matches_reference():
    cfg = config()
    p = layer_params(weights(cfg), 0)["mlp"]
    x = stream(5)
    got = M.swiglu(p, x, torch.float32)
    want = R.swiglu(x, p["gate"]["kernel"], p["up"]["kernel"],
                    p["down"]["kernel"])
    assert rel(got, want) <= ACT_TOL


def test_a_whole_layer_matches_reference():
    cfg = config()
    w = weights(cfg)
    mask = batch_of()["input_mask"]
    cos, sin = M.rope_tables(S, 64, cfg.rope_theta, "cpu")
    bias = R.selection_bias(cfg.to_dict(), "cpu")
    x = stream(6)
    p = layer_params(w, 1)
    got = M.layer(p, x, mask.int(), cos, sin, cfg, torch.float32, bias[0])
    d = cfg.to_dict()
    h = x + R.mla(p["attention"], R.rms_norm(x, p["attention_norm"]["scale"],
                                             1e-5), mask, d)
    h2 = R.rms_norm(h, p["ffn_norm"]["scale"], 1e-5)
    want = h + R.moe(p["moe"], h2.reshape(-1, 32), bias[0], None,
                     d).view(B, S, 32)
    assert rel(got, want) <= ACT_TOL


# --------------------------------------------------------------------------- #
# K11's plain version
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("counts", [[0, 5, 1, 0, 20, 6], [32, 0, 0, 0, 0, 0],
                                    [0, 0, 0, 0, 0, 3]])
def test_expert_gemm_plain_matches_autograd(counts):
    """K11's plain forward and backward against autograd through a loop of
    per-expert SwiGLU products (fp32), uneven and empty experts included:
    fp32 weight gradients, zeros for an empty expert."""
    g = torch.Generator().manual_seed(len(counts) + sum(counts))
    r, h, i = sum(counts), 24, 16
    x = torch.randn((r, h), generator=g).requires_grad_(True)
    ws = [(torch.randn(s, generator=g) * 0.2).requires_grad_(True)
          for s in ((6, h, i), (6, h, i), (6, i, h))]
    c = torch.tensor(counts)
    y = eg.expert_mlp(x, c, *ws)
    dy = torch.randn((r, h), generator=g)
    y.backward(dy)
    got = [x.grad] + [w.grad for w in ws]
    x2 = x.detach().clone().requires_grad_(True)
    ws2 = [w.detach().clone().requires_grad_(True) for w in ws]
    outs, a = [], 0
    for e, n in enumerate(counts):
        outs.append(R.swiglu(x2[a:a + n], ws2[0][e], ws2[1][e], ws2[2][e]))
        a += n
    want_y = torch.cat(outs)
    want_y.backward(dy)
    assert rel(y, want_y) <= ACT_TOL
    for a_, w_ in zip(got, [x2.grad] + [w.grad for w in ws2]):
        w_ = torch.zeros_like(a_) if w_ is None else w_
        assert a_.dtype == torch.float32
        assert (a_ - w_).abs().max() <= GRAD_TOL * max(
            float(w_.abs().max()), 1.0)
    for grad in got[1:]:
        assert bool((grad[[e for e, n in enumerate(counts) if n == 0]] == 0)
                    .all())


def test_tile_schedule_covers_every_row_once():
    counts = torch.tensor([0, 1, 127, 128, 129, 0, 300])
    te, r0, r1 = eg.tile_schedule(counts, int(counts.sum()), bm=128)
    starts = torch.cumsum(counts, 0) - counts
    seen = torch.zeros(int(counts.sum()), dtype=torch.int64)
    for e, a, b in zip(te.tolist(), r0.tolist(), r1.tolist()):
        if e < 0:
            continue
        assert starts[e] <= a < b == starts[e] + counts[e]
        seen[a:min(a + 128, b)] += 1
    assert bool((seen == 1).all())
    assert te.numel() == -(-int(counts.sum()) // 128) + counts.numel()


# --------------------------------------------------------------------------- #
# the whole model
# --------------------------------------------------------------------------- #

def port_loss_and_grads(cfg, w, batch, policy, selections=None):
    """The port's loss and every gradient; the routers' selections are
    appended to ``selections`` ([B, S, k] a MoE layer)."""
    model = SASRecModel(config=cfg, dtype_policy=policy)
    params = unflatten({k: v.clone().requires_grad_(True)
                        for k, v in w.items()})
    orig = M.route

    def recorded(p, x, bias, c):
        out = orig(p, x, bias, c)
        if selections is not None:
            selections.append(out[0].detach().view(B, S, -1))
        return out
    M.route = recorded
    try:
        loss, _ = model.loss_and_metrics(params, batch, training=True,
                                         seed=0)
    finally:
        M.route = orig
    flat = flatten(params)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(flat.items(), grads)}


def reference_loss_and_grads(cfg, w, batch, selections=None, found=None):
    flat = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    total, count = R.nll_sum(R.nest(flat), batch, cfg.to_dict(), selections,
                             found=found)
    loss = total / count
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), dict(zip(flat, grads))


def test_whole_model_loss_and_every_gradient_match_reference():
    cfg = config()
    w, batch = weights(cfg), batch_of()
    loss, grads = port_loss_and_grads(cfg, w, batch, DTypePolicy.f32())
    want, want_grads = reference_loss_and_grads(cfg, w, batch)
    assert abs(float(loss - want)) <= ACT_TOL * abs(float(want))
    assert set(grads) == set(want_grads)
    worst = max(rel(grads[k], want_grads[k]) for k in want_grads)
    assert worst <= GRAD_TOL, worst


def test_whole_model_in_bf16_fails_the_gradient_tolerance():
    cfg = config()
    w, batch = weights(cfg), batch_of()
    sel = []
    _, grads = port_loss_and_grads(cfg, w, batch, DTypePolicy.bf16(), sel)
    _, want_grads = reference_loss_and_grads(cfg, w, batch, sel)
    assert max(rel(grads[k], want_grads[k]) for k in want_grads) \
        > 10 * GRAD_TOL


def test_one_adamw_step_matches_reference():
    """One ``train_step`` of the port (clip, AdamW at lr 1e-3 from the
    first update) against the reference's ``follow`` over the same batch:
    the loss, the clipped gradients' norms and every parameter after the
    step."""
    cfg = config()
    w, batch = weights(cfg), batch_of()
    opt = {"lr": 1e-3, "warmup": 0, "train_steps": 1000, "b1": 0.9,
           "b2": 0.999, "eps": 1e-6, "weight_decay": 0.01, "clip": 1.0,
           "exclude": ["LayerNorm", "layer_norm", "bias", "norm",
                       "scale_bias"]}
    trainer = BERT4RecTrainer(SASRecModel(config=cfg))
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=opt["lr"], num_train_steps=opt["train_steps"],
            num_warmup_steps=0, weight_decay_rate=opt["weight_decay"],
            epsilon=opt["eps"], exclude_from_weight_decay=opt["exclude"],
            global_clipnorm=opt["clip"]),
        params=unflatten({k: v.clone() for k, v in w.items()}), seed=0,
        device="cpu")
    logs = trainer.train_step(batch)
    ref = R.follow(w, [batch], None, cfg.to_dict(), opt, "cpu")
    assert abs(float(logs["loss"]) - ref["losses"][0]) \
        <= ACT_TOL * ref["losses"][0]
    mu = flatten(trainer.state["opt_state"]["mu"])
    for k, norm in ref["grad"].items():
        assert abs(float(mu[k].norm()) / 0.1 - norm) \
            <= GRAD_TOL * max(norm, 1e-3), k
    params = flatten(trainer.state["params"])
    for k, change in ref["change"].items():
        got = float((params[k].detach() - w[k]).norm())
        assert abs(got - change) <= GRAD_TOL * max(change, 1e-6), k


# --------------------------------------------------------------------------- #
# the routing judge
# --------------------------------------------------------------------------- #

def _judged(cfg, w, batch, selections):
    """The judge's rejections of ``selections``."""
    found = []
    reference_loss_and_grads(cfg, w, batch, selections, found)
    return R.tally(torch.cat(found))["rejected"]


def test_judge_accepts_the_programs_bf16_selection():
    cfg = config()
    w, batch = weights(cfg), batch_of()
    sel = []
    port_loss_and_grads(cfg, w, batch, DTypePolicy.bf16(), sel)
    assert len(sel) == 2 and _judged(cfg, w, batch, sel) == 0


def _planted(cfg, w, batch, fault):
    """The reference's own selections, each MoE layer's broken by
    ``fault(scores, bias, k)``; the layers' inputs from a run that
    follows the sound selection."""
    sound = []
    port_loss_and_grads(cfg, w, batch, DTypePolicy.f32(), sound)
    params = R.nest(w)
    bias = R.selection_bias(cfg.to_dict(), "cpu")
    x = params["encoder"]["item_embeddings"]["embedding"][
        batch["input_word_ids"].long()]
    out = []
    d = cfg.to_dict()
    for i in range(cfg.num_layers):
        p = params["encoder"]["layers"][f"layer_{i}"]
        x = x + R.mla(p["attention"], R.rms_norm(
            x, p["attention_norm"]["scale"], 1e-5), batch["input_mask"], d)
        h2 = R.rms_norm(x, p["ffn_norm"]["scale"], 1e-5).reshape(B * S, -1)
        if "mlp" in p:
            m = p["mlp"]
            x = x + R.swiglu(h2, m["gate"]["kernel"], m["up"]["kernel"],
                             m["down"]["kernel"]).view(B, S, -1)
            continue
        j = i - cfg.first_k_dense_replace
        scores = R.router_scores(p["moe"], h2)
        out.append(fault(scores, bias[j], cfg.num_experts_per_tok)
                   .view(B, S, -1))
        x = x + R.moe(p["moe"], h2, bias[j], sound[j].reshape(B * S, -1),
                      d).view(B, S, -1)
    return out


def test_judge_rejects_a_selection_without_the_bias():
    cfg = config()
    w, batch = weights(cfg), batch_of()
    sel = _planted(cfg, w, batch,
                   lambda s, b, k: torch.topk(s, k, -1).indices)
    assert _judged(cfg, w, batch, sel) > 0


def test_judge_rejects_top5_plus_a_random_expert():
    cfg = config()
    w, batch = weights(cfg), batch_of()
    g = torch.Generator().manual_seed(3)

    def fault(s, b, k):
        order = torch.argsort(s + b, -1, descending=True)
        pick = torch.randint(k, s.shape[-1], (s.shape[0], 1), generator=g)
        return torch.cat([order[:, :k - 1], order.gather(1, pick)], -1)
    assert _judged(cfg, w, batch, _planted(cfg, w, batch, fault)) > 0


# --------------------------------------------------------------------------- #
# the surface
# --------------------------------------------------------------------------- #

def test_a_jax_era_encoder_config_loads_into_the_bert_block(tmp_path):
    """An ``encoder_config.json`` the JAX package writes (none of the new
    keys) loads as the BERT block, and writes back key for key."""
    d = JaxConfig(vocab_size=40, hidden_size=16, num_layers=1,
                  num_attention_heads=2, inner_dim=32).to_dict()
    path = tmp_path / "encoder_config.json"
    path.write_text(json.dumps(d))
    cfg = BERT4RecConfig.from_json_file(path)
    assert cfg.block == "bert" and cfg.to_dict() == d
    model = BERT4RecModel(config=cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    assert "position_embeddings" in params["encoder"]


def test_mla_moe_config_round_trips_and_refuses_dropout():
    cfg = config()
    assert BERT4RecConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.to_dict()["block"] == "mla_moe"
    with pytest.raises(ValueError):
        SASRecModel(config=config(output_dropout=0.1))
    with pytest.raises(ValueError):
        BERT4RecConfig(vocab_size=9, block="moe")


def test_wrapper_round_trip_of_the_block(tmp_path):
    cfg = config()
    model = SASRecModel(config=cfg)
    params = unflatten({k: v.clone() for k, v in weights(cfg).items()})
    BERT4RecModelWrapper(model, params).save(tmp_path / "m", mode=2)
    wrapper, _ = BERT4RecModelWrapper.load(tmp_path / "m", mode=2,
                                           device="cpu")
    assert wrapper.model.config == cfg
    got, want = flatten(wrapper.params), flatten(params)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    batch = batch_of()
    a = model.apply(params, batch)["mlm_logits"]
    b = wrapper.model.apply(wrapper.params, batch)["mlm_logits"]
    assert torch.equal(a, b)


def test_the_reference_imports_nothing_of_the_port_or_jax():
    """The reference the tests and the benchmark share is plain PyTorch."""
    code = ("import sys; import reference_mla_moe; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('bert4rec_tpu', 'bert4rec_tpu_torch', 'jax', 'jaxlib')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT / "tests",
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_selection_bias_is_the_references_law():
    cfg = config(router_bias_seed=2 ** 40 + 7)
    enc = SASRecModel(config=cfg).encoder
    assert torch.equal(enc.selection_bias("cpu"),
                       R.selection_bias(cfg.to_dict(), "cpu"))
    assert enc.selection_bias("cpu").shape == (2, 64)


def test_a_train_step_records_the_spans_and_counts_the_rows():
    cfg = config()
    trainer = BERT4RecTrainer(SASRecModel(config=cfg))
    trainer.initialize_model(params=unflatten(weights(cfg)), seed=0,
                             device="cpu")
    M.routing_counts.reset()
    with profiling.record_spans() as log:
        logs = trainer.train_step(batch_of())
    assert np.isfinite(float(logs["loss"]))
    names = [s.name for s in log]
    for name, n in (("mla.attention", 3), ("moe.route", 2),
                    ("moe.experts", 2), ("moe.shared", 2),
                    ("moe.combine", 2)):
        assert names.count(name) == n, name
    assert M.routing_counts.read() == {
        "routed_rows": 2 * B * S * 6, "max_expert_rows":
            M.routing_counts.read()["max_expert_rows"], "dropped_rows": 0}
    assert 6 <= M.routing_counts.read()["max_expert_rows"] <= B * S
