"""Operations, bytes and least times of the port's kernels and model, from
shapes (a frozen copy of chip_smoke.py's arithmetic), against the published
peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
989 TFLOP/s bf16, 67 TFLOP/s fp32 outside the tensor cores, 3xTF32 at a
third of TF32's 495, 3.35 TB/s of HBM. No recomputation is counted."""

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TF32X3_FLOPS = 495e12 / 3


def _bound(flops, nbytes, peak) -> float:
    """Least seconds: the larger of operations over the peak and bytes
    over the HBM rate."""
    return max(flops / peak, nbytes / HBM_BYTES_S)


def layer_peak(dtype: str) -> float:
    return TF32X3_FLOPS if dtype == "float32" else PEAK_FLOPS[dtype]


def layer_forward_flops(b, s, h, f) -> float:
    """K1 / K1': 2SH*3H + 4S^2H + 2SH^2 + 4SHF per sequence."""
    return b * (2 * s * h * 3 * h + 4 * s * s * h + 2 * s * h * h
                + 4 * s * h * f)


def _layer_param_bytes(h, f) -> int:
    return 4 * (4 * h * h + 2 * h * f + 3 * h + h + 4 * h + f + h)


def layer_forward_s(b, s, h, f, dtype="bfloat16") -> float:
    es = 4 if dtype == "float32" else 2
    nbytes = 2 * b * s * h * es + b * s * 4 + _layer_param_bytes(h, f)
    return _bound(layer_forward_flops(b, s, h, f), nbytes, layer_peak(dtype))


def layer_backward_s(b, s, h, f, dtype="bfloat16") -> float:
    """K2: twice the forward's products; x, dy, mask and the fp32 params
    read, dx and the fp32 grads written."""
    es = 4 if dtype == "float32" else 2
    nbytes = 3 * b * s * h * es + b * s * 4 + 2 * _layer_param_bytes(h, f)
    return _bound(2 * layer_forward_flops(b, s, h, f), nbytes,
                  layer_peak(dtype))


def loss_s(rows, v, w, backward, dtype="bfloat16") -> float:
    """K5 (2RVW) or K6 (6RVW); hidden, table, bias and labels read once,
    the outputs written once."""
    es = 4 if dtype == "float32" else 2
    nbytes = rows * w * es + v * w * es + v * 4 + rows * 4
    nbytes += (rows * w * es + v * w * 4 + v * 4) if backward else rows * 4
    return _bound((6 if backward else 2) * rows * v * w, nbytes,
                  PEAK_FLOPS[dtype])


def flash_s(b, n, s, d, backward, dtype="bfloat16") -> float:
    """K8 (4BNS^2D; q, k, v, mask read, o written) or K9 (8BNS^2D; q, k,
    v, dO, mask read, dq, dk, dv written)."""
    es = 4 if dtype == "float32" else 2
    flops = (8 if backward else 4) * b * n * s * s * d
    nbytes = (7 if backward else 4) * b * n * s * d * es + b * s * 4
    return _bound(flops, nbytes, PEAK_FLOPS[dtype])


def train_step_flops(cfg: dict, batch: int) -> float:
    """Model operations of one training step: per layer and sequence
    8SH^2 + 4SHF + 4S^2H forward (24SH^2 + 4S^2H with F = 4H), the MLM
    head's 2RVH, all three times for the forward and the backward."""
    s, h = cfg["max_sequence_length"], cfg["hidden_size"]
    f = cfg["inner_dim"]
    rows = batch * cfg["max_predictions_per_seq"]
    layers = cfg["num_layers"] * batch * (8 * s * h * h + 4 * s * h * f
                                          + 4 * s * s * h)
    return 3 * (layers + 2 * rows * cfg["vocab_size"] * h)
