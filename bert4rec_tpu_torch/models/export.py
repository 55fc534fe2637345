"""Ahead-of-time serving export (port of ``bert4rec_tpu/models/export.py``,
``jax.export`` replaced by ``torch.export``).

The serving computation is traced by ``torch.export.export`` with the
weights in the exported program (buffers), and ``torch.export.save``
writes it to one ``.pt2`` file. A serving process loads it and calls it:
no model code, no config, no weight files.

The batch dimension is exported symbolically by default (a
``torch.export.Dim``), so one artifact serves any batch up to
``batch_limit(model)``; sequence length and prediction count stay static.

Exported entry points::

    top_k:            (input_word_ids [b,S], input_mask [b,S],
                       masked_lm_positions [b,P][, exclude [b,E]])
                      -> (ids, scores) [b,P,k]
    score_candidates: (... , candidates [b,P,C]) -> logits [b,P,C]

The artifact runs on the device its params were on when it was exported
(JAX's ``platforms``). The port's kernels are registered operators
(``torch.ops.bert4rec_tpu_torch.fused_layer_forward``, ``...
.flash_attention_forward``): the program holds them as calls, so a ``.pt2``
loads only where ``bert4rec_tpu_torch.ops`` is imported (JAX's artifact
needs only jax; ROADMAP.md §C).
"""

import pathlib
from typing import Optional, Sequence

import torch

from bert4rec_tpu_torch.ops import fused_encoder_layer as fel
from bert4rec_tpu_torch.utils import checkpoint

_INPUTS = ("input_word_ids", "input_mask", "masked_lm_positions")


def batch_limit(model) -> int:
    """The largest batch an exported program of ``model`` takes: every
    batch up to it routes as batch 1 does, so the symbolic batch adds no
    guard. The fused layer's kernels take at most ``MAX_KERNEL_BATCH``
    rows, and where the layer is fused at batch 1, JAX's VMEM law
    (``fused_layer_supported``, which counts the batch's mask) caps the
    batch at the last size it still fuses."""
    cfg = model.config
    enc = model.encoder

    def fused(b):
        return enc.fused_layer_routed(b, cfg.max_sequence_length)

    hi = fel.MAX_KERNEL_BATCH
    if not fused(1) or fused(hi):
        return hi
    lo = 1            # fused(lo) and not fused(hi): the law is monotone
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fused(mid) else (lo, mid)
    return lo


def _prepare_params(params: dict, quantize: Optional[str]) -> dict:
    params = checkpoint.unflatten({k: v.detach() for k, v in
                                   checkpoint.flatten(params).items()})
    if quantize is None:
        return params
    if quantize != "int8":
        raise ValueError(f"unknown quantize mode {quantize!r}; "
                         "supported: None, 'int8'")
    from bert4rec_tpu_torch.models import quantization
    return quantization.quantize_params(params)


class _Served(torch.nn.Module):
    """A model's params as buffers (``/`` in a path becomes ``__``) and one
    of its serving methods as ``forward``."""

    def __init__(self, model, params: dict, method: str, **kwargs):
        super().__init__()
        self.model = model
        self.method = method
        self.kwargs = kwargs
        self.paths = list(checkpoint.flatten(params))
        for path, leaf in checkpoint.flatten(params).items():
            self.register_buffer(path.replace("/", "__"), leaf)

    def params(self) -> dict:
        return checkpoint.unflatten({p: getattr(self, p.replace("/", "__"))
                                     for p in self.paths})

    def forward(self, input_word_ids, input_mask, masked_lm_positions,
                extra=None):
        inputs = dict(zip(_INPUTS, (input_word_ids, input_mask,
                                    masked_lm_positions)))
        if self.method == "rank_top_k":
            return self.model.rank_top_k(self.params(), inputs,
                                         exclude=extra, **self.kwargs)
        return self.model.score_candidates(self.params(), inputs, extra)


def _export(module: _Served, specs: list, batch_size: Optional[int]):
    """``torch.export.export`` of ``module`` over int32 inputs of
    ``specs`` (shapes after the batch), on the device of its params."""
    device = next(module.buffers()).device
    if batch_size is None:
        b = torch.export.Dim("b", min=1, max=batch_limit(module.model))
        sample = 2
        dynamic = tuple({0: b} for _ in specs)
    else:
        sample, dynamic = int(batch_size), None
    args = tuple(torch.zeros((sample, *shape), dtype=torch.int32,
                             device=device) for shape in specs)
    with torch.no_grad():
        return torch.export.export(module, args, dynamic_shapes=dynamic,
                                   strict=False)


def _check_platforms(params: dict, platforms: Optional[Sequence[str]]):
    """JAX's ``platforms`` names the lowering platforms; a port artifact
    runs on the device its params lie on, so each platform named must be
    that device's (``gpu`` and ``cuda`` name a CUDA card)."""
    if platforms is None:
        return
    device = next(iter(checkpoint.flatten(params).values())).device.type
    names = [str(p).lower() for p in ([platforms] if isinstance(
        platforms, str) else platforms)]
    if not names or any({"gpu": "cuda"}.get(n, n) != device for n in names):
        raise ValueError(
            f"platforms={list(names)}: a torch.export artifact runs on the "
            f"device its params lie on ({device}); move the params there "
            f"to export for another platform")


def export_top_k(model, params: dict, k: int, *,
                 batch_size: Optional[int] = None,
                 num_positions: Optional[int] = None,
                 num_exclude: Optional[int] = None,
                 platforms: Optional[Sequence[str]] = None,
                 quantize: Optional[str] = None
                 ) -> torch.export.ExportedProgram:
    """Export full-vocab top-k ranking (``model.rank_top_k``) with the
    weights in the program.

    :param batch_size: concrete batch, or None for a symbolic batch
    :param num_positions: masked positions per row (default: the config's
        ``max_predictions_per_seq``)
    :param num_exclude: when set, the program takes a FOURTH input
        ``exclude [b, num_exclude]`` of item ids (< 0 = padding) removed
        from the ranking per row (seen items and special tokens,
        ``apps.ArtifactRecommender``)
    :param platforms: JAX's lowering platforms: each must name the
        device the params lie on, where the artifact runs (ValueError
        otherwise)
    :param quantize: ``"int8"`` embeds the item table weights-only
        quantized (models/quantization.py)
    """
    _check_platforms(params, platforms)
    cfg = model.config
    p = num_positions or cfg.max_predictions_per_seq
    s = cfg.max_sequence_length
    module = _Served(model, _prepare_params(params, quantize), "rank_top_k",
                     k=int(k))
    specs = [(s,), (s,), (p,)]
    if num_exclude is not None:
        specs.append((int(num_exclude),))
    return _export(module, specs, batch_size)


def export_score_candidates(model, params: dict, num_candidates: int, *,
                            batch_size: Optional[int] = None,
                            num_positions: Optional[int] = None,
                            platforms: Optional[Sequence[str]] = None,
                            quantize: Optional[str] = None
                            ) -> torch.export.ExportedProgram:
    """Export candidate-only scoring (``model.score_candidates``, the
    ``[B, P, C]`` path that never builds full-vocab logits) with the
    weights in the program; ``platforms`` and ``quantize="int8"`` as in
    :func:`export_top_k`."""
    _check_platforms(params, platforms)
    cfg = model.config
    p = num_positions or cfg.max_predictions_per_seq
    s = cfg.max_sequence_length
    module = _Served(model, _prepare_params(params, quantize),
                     "score_candidates")
    return _export(module, [(s,), (s,), (p,), (p, int(num_candidates))],
                   batch_size)


def input_shapes(exported: torch.export.ExportedProgram) -> list:
    """The shapes of an exported program's user inputs, in order (the
    batch as its symbol where it is symbolic)."""
    names = set(exported.graph_signature.user_inputs)
    return [tuple(n.meta["val"].shape) for n in exported.graph.nodes
            if n.op == "placeholder" and n.name in names]


def output_shapes(exported: torch.export.ExportedProgram) -> list:
    """The shapes of an exported program's outputs, in order."""
    out = next(n for n in exported.graph.nodes if n.op == "output")
    return [tuple(a.meta["val"].shape) for a in out.args[0]]


def save_artifact(exported: torch.export.ExportedProgram, path) -> None:
    """Write an exported program to one self-contained ``.pt2`` file
    (atomically: a temporary file beside it, then a rename)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp.pt2")
    torch.export.save(exported, str(tmp))
    tmp.replace(path)


def load_artifact(path) -> torch.export.ExportedProgram:
    """Read a serving artifact; run it with ``artifact.module()(...)``.
    Needs ``bert4rec_tpu_torch.ops`` imported (the kernels' registered
    operators), none of the model's code or weight files."""
    import bert4rec_tpu_torch.ops  # noqa: F401  (registers the operators)
    return torch.export.load(str(pathlib.Path(path)))
