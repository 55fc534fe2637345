"""Patches that send every kernel call of the port to its plain PyTorch
version: the reference a kernel step, an evaluation or a training run on
the card is held against (``chip_smoke.py``, ``tools/oracle_drift.py``).

    with ExitStack() as stack:
        for patch in plain_kernels():
            stack.enter_context(patch)
        ...  # the same calls, on the plain versions
"""

import importlib


def plain_kernels():
    """Patches that send the CUDA branches of the flash attention, layer,
    loss and table-gradient Functions and of the update to the plain
    versions: the reference of the step check."""
    from unittest import mock
    from bert4rec_tpu_torch.ops import adamw
    fa = importlib.import_module("bert4rec_tpu_torch.ops.flash_attention")
    from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
    from bert4rec_tpu_torch.ops import fused_mlm_loss as fml
    from bert4rec_tpu_torch.ops import table_gradient as tg

    def layer_fwd(flat, x, mask, num_heads, seed, a, o, save, causal=False,
                  rel=None):
        return fel._forward_math(flat, x, mask, num_heads, seed, a, o,
                                 causal, rel)["y"], ()

    def layer_bwd(flat, x, mask, dy, saved, num_heads, seed, a, o,
                  causal=False, rel=None):
        return fel.fused_encoder_layer_plain_backward(
            flat, x, mask, dy, num_heads=num_heads, attention_dropout=a,
            output_dropout=o, seed=seed, causal=causal, rel_bias=rel)

    def loss_bwd(hidden, table, bias, labels, lse, g, n_valid):
        return fml.fused_mlm_loss_plain_backward(hidden, table, bias, labels,
                                                 lse, g, n_valid[0])

    def tiled_bwd(hidden, table, bias, labels, lse, g, n_valid, merged,
                  valid_ge_zero=False):
        return fml.fused_mlm_loss_plain_backward(
            hidden, table, bias, labels, lse, g, n_valid[0], valid_ge_zero)

    def flash_fwd(q, k, v, mask, seed, rate, causal, save):
        return fa.mha_reference(q, k, v, mask, rate, seed, causal), ()

    def flash_bwd(q, k, v, mask, do, saved, seed, rate, causal):
        return fa.flash_attention_plain_backward(
            q, k, v, mask, do, dropout_rate=rate, seed=seed, causal=causal)

    patches = [mock.patch.object(fa, "_launch_forward", flash_fwd),
               mock.patch.object(fa, "_launch_backward", flash_bwd),
               mock.patch.object(fel, "_launch_forward", layer_fwd),
               mock.patch.object(fel, "_launch_backward", layer_bwd),
               mock.patch.object(fml, "_launch_forward",
                                 fml.fused_mlm_loss_plain_forward),
               mock.patch.object(fml, "_launch_backward", loss_bwd),
               mock.patch.object(fml, "_launch_forward_tiled",
                                 fml.fused_mlm_loss_plain_forward),
               mock.patch.object(fml, "_launch_backward_tiled", tiled_bwd),
               mock.patch.object(tg, "_launch", tg.table_gradient_plain),
               mock.patch.object(adamw, "_launch", adamw.adamw_update_plain)]
    return patches
