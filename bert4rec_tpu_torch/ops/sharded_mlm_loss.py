"""Vocab-sharded fused tied-softmax loss (port of
``bert4rec_tpu/ops/sharded_mlm_loss.py``).

Each rank holds a block of the table's rows (and of the bias) on the
mesh's 'model' axis and sweeps only its block with the vocab-tiled kernels
of ``ops/fused_mlm_loss.py``; only per-row statistics cross the ranks:

    forward:  K5's stats entry on the local block -> (m, s, ll) per row;
              lse from the max (all_reduce MAX) and the rescaled sums
              (all_reduce SUM) over 'model', the label logit summed over
              'model'; the loss and both metrics fall out, and the scalars
              are summed over 'data', so every rank holds the global ones.
              Accuracy is label_logit >= the global max, the unsharded
              kernels' formulation.
    backward: K6 or K7 (JAX's ``merged_backward`` law) with
              ``valid_ge_zero`` recompute p = exp(logits_local - lse) on
              the local block; dh is summed over 'model'.

Label encodings, as JAX's: the forward gives a label the owning rank's
local column, else -2 (matches no column and counts nothing), where label
0 is owned by rank 0, so the all-rows accuracy keeps the unsharded
paths' law; the backward gives valid remote labels ``v_local + 7`` (weight
1, no column) and invalid ones -1 (weight 0). Vocab-padding columns get
-1e9 in the local bias.

The table's and bias's gradients are this rank's share of the global
batch: the trainer sums every gradient over 'data' once (JAX sums dtable
and dbias over 'data' inside the op); nothing is summed over 'model'.
"""

import torch

from bert4rec_tpu_torch.core import mesh as mesh_lib
from bert4rec_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS
from bert4rec_tpu_torch.ops import fused_mlm_loss as fml

NEG_INF = fml.NEG_INF


def _mask_local_bias(bias_l: torch.Tensor, offset: int,
                     vocab_size: int) -> torch.Tensor:
    """NEG_INF on this shard's columns at or after the true vocab size."""
    col = torch.arange(bias_l.shape[0], device=bias_l.device) + offset
    return torch.where(col >= vocab_size, torch.full_like(bias_l, NEG_INF),
                       bias_l)


def _local_labels(labels: torch.Tensor, offset: int, v_local: int):
    local = labels.long() - offset
    return local, (local >= 0) & (local < v_local)


class _ShardedLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, table, bias, labels, vocab_size, mesh):
        v_local = table.shape[0]
        offset = mesh.index(MODEL_AXIS) * v_local
        table_s = table.to(hidden.dtype).contiguous()
        bias_m = _mask_local_bias(bias.float(), offset,
                                  vocab_size).contiguous()
        hidden = hidden.contiguous()
        local, owned = _local_labels(labels, offset, v_local)
        lab_fwd = torch.where((labels >= 0) & owned, local,
                              torch.full_like(local, -2)).to(torch.int32)
        if hidden.device.type == "cpu":
            m, s, ll = fml.fused_mlm_loss_plain_stats(hidden, table_s,
                                                      bias_m, lab_fwd)
        else:
            m, s, ll = fml._launch_forward_tiled_stats(hidden, table_s,
                                                       bias_m, lab_fwd)
            sharded_fused_mlm_loss.launches += 1
        big_m = mesh_lib.all_reduce(mesh, m.clone(), MODEL_AXIS, "max")
        big_s = mesh_lib.all_reduce(mesh, s * torch.exp(m - big_m),
                                    MODEL_AXIS)
        lse = big_m + torch.log(big_s)
        label_logit = mesh_lib.all_reduce(mesh, ll.clone(), MODEL_AXIS)
        w = (labels > 0).float()
        nll = (lse - label_logit) * w
        correct = (label_logit >= big_m).float()
        sums = torch.stack([nll.sum(), (correct * w).sum(), correct.sum(),
                            w.sum()])
        sums = mesh_lib.all_reduce(mesh, sums, DATA_AXIS)

        valid = labels > 0
        lab_bwd = torch.where(valid & owned, local, torch.where(
            valid, torch.full_like(local, v_local + 7),
            torch.full_like(local, -1))).to(torch.int32)
        ctx.save_for_backward(hidden, table_s, bias_m, lab_bwd, lse,
                              sums[3:4].clone())
        ctx.mesh = mesh
        ctx.dtypes = (table.dtype, bias.dtype)
        loss = sums[0] / torch.clamp(sums[3], min=1.0)
        cv, ca, nv = sums[1].clone(), sums[2].clone(), sums[3].clone()
        ctx.mark_non_differentiable(cv, ca, nv)
        return loss, cv, ca, nv

    @staticmethod
    def backward(ctx, g_loss, *_):
        hidden, table_s, bias_m, lab_bwd, lse, nv = ctx.saved_tensors
        if hidden.device.type == "cpu":
            dh, dt, db = fml.fused_mlm_loss_plain_backward(
                hidden, table_s, bias_m, lab_bwd, lse, g_loss, nv[0],
                valid_ge_zero=True)
        else:
            merged = fml.merged_backward(*hidden.shape)
            dh, dt, db = fml._launch_backward_tiled(
                hidden, table_s, bias_m, lab_bwd, lse, g_loss, nv, merged,
                valid_ge_zero=True)
            if merged:
                sharded_fused_mlm_loss.merged_launches += 1
            else:
                sharded_fused_mlm_loss.two_sweep_launches += 1
        dh = mesh_lib.all_reduce(ctx.mesh, dh.float(), MODEL_AXIS)
        t_dtype, b_dtype = ctx.dtypes
        return (dh.to(hidden.dtype), dt.to(t_dtype), db.to(b_dtype), None,
                None, None)


def sharded_fused_mlm_loss(hidden: torch.Tensor, table: torch.Tensor,
                           bias: torch.Tensor, labels: torch.Tensor,
                           vocab_size: int, mesh):
    """``(loss_mean, masked_correct, all_correct, n_valid)`` over the global
    batch, on every rank: the contract of ``fused_mlm_loss``, for this
    rank's rows ``hidden [R, W]`` / ``labels [R]`` int32 (its 'data'
    slice) and its block ``table [Vp / mp, W]`` / ``bias [Vp / mp]`` of the
    'model' axis. A CUDA ``hidden`` launches K5's stats entry (counted in
    ``.launches``) and in backward K6 or K7 (``.merged_launches`` /
    ``.two_sweep_launches``)."""
    fml._check_operands(hidden, table, bias, labels)
    return _ShardedLoss.apply(hidden, table, bias, labels, int(vocab_size),
                              mesh)


sharded_fused_mlm_loss.launches = 0
sharded_fused_mlm_loss.merged_launches = 0
sharded_fused_mlm_loss.two_sweep_launches = 0


def sharded_mlm_loss_and_metrics(hidden, table, bias, labels, vocab_size,
                                 mesh):
    """``(loss, {"masked_accuracy", "accuracy"})``, the twin of
    ``fused_mlm_loss.mlm_loss_and_metrics`` for a vocab-sharded table;
    ``hidden`` is ``[B, P, W]`` or ``[R, W]``. Both metrics are over the
    global batch."""
    rows = hidden.shape[0] * hidden.shape[1] if hidden.dim() == 3 \
        else hidden.shape[0]
    loss, cv, ca, nv = sharded_fused_mlm_loss(
        hidden.reshape(rows, hidden.shape[-1]), table, bias,
        labels.reshape(rows).to(torch.int32), vocab_size, mesh)
    rows_global = rows * mesh.size(DATA_AXIS)
    return loss, {"masked_accuracy": cv / torch.clamp(nv, min=1.0),
                  "accuracy": ca / rows_global}
