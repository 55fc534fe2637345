"""Hand counts of ``roofline_mla_moe.py`` at the moonlight_5L cell's
configuration: the parameters of each part (from Moonlight-16B-A3B's
published widths) and the training step's operations
at B=64, S=200, P=199."""

import pytest

from benchmark import harness, roofline_mla_moe as r

CFG = harness.load_json(harness.ROOT / "benchmark/configs/"
                        "moonlight-16b-a3b_5L.json")["model"]


def test_a_layers_parameters():
    # W_q 2048 x 16 x 192, W_kv_down 2048 x 576, W_kv_up 512 x 16 x 256,
    # W_o 16 x 128 x 2048, the input norm and the latent's: 13.77 M
    assert r.mla_params(CFG) == 6_291_456 + 1_179_648 + 2_097_152 \
        + 4_194_304 + 2048 + 512
    # 64 experts x 3 x 2048 x 1408 = 553.65 M; shared 3 x 2048 x 2816 =
    # 17.30 M; the router 64 x 2048
    assert r.moe_layer_params(CFG) == pytest.approx(584.84e6, rel=1e-4)
    assert r.dense_layer_params(CFG) == pytest.approx(82.97e6, rel=1e-4)
    assert r.head_params(CFG) == pytest.approx(59.0e6, rel=1e-3)
    assert r.total_params(CFG) == pytest.approx(2.48e9, rel=1e-3)


def test_the_steps_operations():
    # forward per token: 5 x 2 x 13.77 M (attention), 6 x 2048 x 11,264
    # (the dense layer), 4 x (2 x 17.30 M + 2 x 2048 x 64) (shared, router),
    # 24 x 6 x 6 x 2048 x 1408 per routed row / token; causal attention's
    # 5 x 16 x 20,100 pairs x 2 x 320 a sequence; the head's 2 (2048^2 +
    # 2048 x 26,732) a position; times 3: 36.6 TFLOP
    assert r.train_step_flops(CFG, 64) == pytest.approx(36.6e12, rel=1e-3)
    tokens = 64 * 200
    moe = 3 * tokens * 6 * 4 * 6 * 2048 * 1408
    shared = 3 * tokens * 4 * (2 * r.shared_params(CFG) + 2 * 2048 * 64)
    assert (moe + shared) / r.train_step_flops(CFG, 64) \
        == pytest.approx(0.58, abs=0.01)


def test_the_kernels_bounds():
    # K11 at 76,800 rows: 6 R H I = 1.329 TFLOP forward, twice backward,
    # both bound by operations at 989 TFLOP/s
    assert r.expert_s(76_800, CFG, False) == pytest.approx(
        6 * 76_800 * 2048 * 1408 / 989e12, rel=1e-9)
    assert r.expert_s(76_800, CFG, True) == pytest.approx(
        2 * r.expert_s(76_800, CFG, False), rel=1e-9)
    # K8 at B=64, N=16, S=200, causal: 2 x 20,100 pairs x 320 per head;
    # bound by bytes (105 MB at 3.35 TB/s against 13.2 GFLOP)
    flops = 2 * 64 * 16 * 20_100 * 320
    nbytes = 64 * 16 * 200 * 2 * (2 * 192 + 2 * 128) + 64 * 200 * 4
    assert r.flash_s(CFG, 64, False) == pytest.approx(
        max(flops / 989e12, nbytes / 3.35e12), rel=1e-9)
    assert nbytes / 3.35e12 > flops / 989e12
