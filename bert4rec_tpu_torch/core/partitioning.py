"""Parameter and batch partition specs, and the cuts between a whole train
state and this rank's pieces (port of ``bert4rec_tpu/core/partitioning.py``).

- item embedding table ``[V, W]`` -> ``('model', None)`` (row-sharded);
- MLM output bias ``[V]``         -> ``('model',)``;
- every other parameter            -> replicated ``()``;
- batches                          -> leading dim over ``'data'``.

Specs are derived from parameter paths (``/``-joined, as the checkpoint's
keys), so the optimizer's moments (``.../mu/<param path>``) follow their
params. A spec is a tuple of axis names (or None) per dim. Where JAX places
a leaf with a ``NamedSharding``, the port's rank keeps its own piece:
:func:`shard_state` cuts a whole state to this rank's pieces and
:func:`gather_state` puts the whole leaves back together on every rank.
"""

import re
import warnings
from typing import Any, Dict

import numpy as np
import torch

from bert4rec_tpu_torch.core import mesh as mesh_lib
from bert4rec_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS, Mesh

# path-regex -> spec; first match wins
_RULES = (
    # the tied item-embedding table: rows = vocab
    (re.compile(r"item_embeddings.*embedding$"), (MODEL_AXIS, None)),
    # mlm output bias over the vocab
    (re.compile(r"output_bias$"), (MODEL_AXIS,)),
)


def _flatten(tree, prefix=""):
    from bert4rec_tpu_torch.utils.checkpoint import flatten
    return flatten(tree, prefix)


def _unflatten(flat):
    from bert4rec_tpu_torch.utils.checkpoint import unflatten
    return unflatten(flat)


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


def spec_for_path(path: str, leaf) -> tuple:
    """The rule's spec for the leaf at ``path`` (``()`` = replicated)."""
    for rule, spec in _RULES:
        if rule.search(path):
            # a scalar or lower-rank leaf that matched by name
            return spec[:_ndim(leaf)]
    return ()


def param_partition_specs(params: dict) -> dict:
    """The params' tree of specs, by path."""
    return _unflatten({k: spec_for_path(k, v)
                       for k, v in _flatten(params).items()})


def _shardable(mesh: Mesh, shape, spec: tuple) -> bool:
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if dim >= len(shape) or shape[dim] % mesh.size(axis) != 0:
            return False
    return True


def _flat_shardings(mesh: Mesh, flat: dict) -> Dict[str, tuple]:
    out = {}
    for k, leaf in flat.items():
        spec = spec_for_path(k, leaf)
        shape = tuple(getattr(leaf, "shape", ()))
        if spec and not _shardable(mesh, shape, spec):
            warnings.warn(
                f"Parameter {k} of shape {shape} cannot be sharded as "
                f"{spec} on mesh {mesh.shape}; replicating. Pad the "
                f"dimension (e.g. vocab_pad_to) to shard it.")
            spec = ()
        out[k] = spec
    return out


def param_shardings(mesh: Mesh, params: dict) -> dict:
    """Path rules -> specs on ``mesh``, replicating (with JAX's warning) a
    leaf whose sharded dim the axis does not divide, e.g. a 43-item vocab
    on a 2-way 'model' axis: pad the vocab with ``vocab_pad_to`` to shard
    it."""
    return _unflatten(_flat_shardings(mesh, _flatten(params)))


def vocab_sharded(mesh, rows: int, vocab_rows: int) -> bool:
    """Whether a table of ``rows`` rows is this rank's shard of a
    ``vocab_rows``-row table on ``mesh``'s 'model' axis (False for a whole,
    replicated table and without a mesh)."""
    if mesh is None:
        return False
    mp = mesh.size(MODEL_AXIS)
    return mp > 1 and vocab_rows % mp == 0 and rows * mp == vocab_rows


def make_batch_specs(batch: dict) -> dict:
    """Specs sharding every batch leaf's leading dim over 'data'."""
    return {k: (DATA_AXIS, *([None] * (np.ndim(v) - 1)))
            for k, v in batch.items()}


def place_batch(mesh: Mesh, arrays: dict, stacked: bool = False,
                what: str = "batch", local: bool = True) -> dict:
    """This rank's slice of a batch on its device, the leading dim (dim 1
    of ``[K, B, ...]`` leaves when ``stacked``) split over the 'data' axis.

    ``local`` (the default: ``jax.make_array_from_process_local_data``,
    one process per rank) means ``arrays`` already are this rank's slice,
    the same on every rank of its 'data' coordinate; :func:`check_batch`
    holds its leaves to one row count. ``local=False`` takes the global
    batch (JAX's one-process ``device_put``) and cuts this rank's slice,
    raising JAX's error where the global size does not divide 'data'."""
    if not local:
        arrays = global_slice(mesh, arrays, stacked, what)
    check_batch(mesh, arrays, stacked, what)
    return {k: (v if torch.is_tensor(v)
                else torch.from_numpy(np.ascontiguousarray(v)))
            .to(mesh.device) for k, v in arrays.items()}


def _rows(arrays: dict, stacked: bool) -> dict:
    dim = 1 if stacked else 0
    return {k: np.shape(v)[dim] for k, v in arrays.items()}


def check_batch(mesh: Mesh, arrays: dict, stacked: bool = False,
                what: str = "batch") -> None:
    """Raise unless every leaf of a rank's slice has the same rows."""
    rows = _rows(arrays, stacked)
    if len(set(rows.values())) > 1:
        raise ValueError(f"the leaves of this rank's {what} slice disagree "
                         f"on its rows: {rows}")


def global_slice(mesh: Mesh, arrays: dict, stacked: bool = False,
                 what: str = "batch") -> dict:
    """This rank's contiguous piece of a global batch over 'data'."""
    b = max(_rows(arrays, stacked).values())
    data_size = mesh.size(DATA_AXIS)
    if b % data_size != 0:
        raise ValueError(
            f"global {what} size {b} ({b} per process) does not divide "
            f"the mesh's 'data' axis ({data_size} devices) — pick a "
            f"multiple (got mesh {mesh.shape})")
    n, d = b // data_size, mesh.index(DATA_AXIS)
    cut = (slice(None),) if stacked else ()
    return {k: v[cut + (slice(d * n, (d + 1) * n),)]
            for k, v in arrays.items()}


def _piece(mesh: Mesh, leaf, spec: tuple):
    """This rank's block of ``leaf`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = leaf.shape[dim] // mesh.size(axis)
        i = mesh.index(axis)
        leaf = leaf[(slice(None),) * dim + (slice(i * n, (i + 1) * n),)]
    return leaf


def shard_flat(mesh: Mesh, flat: dict) -> dict:
    """``{path: leaf}`` with each sharded leaf cut to this rank's block
    (numpy arrays and tensors alike; a tensor's block is a copy)."""
    out = {}
    for k, spec in _flat_shardings(mesh, flat).items():
        leaf = flat[k]
        piece = _piece(mesh, leaf, spec) if spec else leaf
        if torch.is_tensor(piece) and spec:
            piece = piece.detach().clone().requires_grad_(
                leaf.requires_grad)
        out[k] = piece
    return out


def shard_state(mesh: Mesh, tree: Any) -> Any:
    """A whole state (params, optimizer moments: any tree keyed by param
    paths) cut to this rank's pieces by the path rules."""
    return _unflatten(shard_flat(mesh, _flatten(tree)))


def gather_flat(mesh: Mesh, flat: dict, vocab_rows: int) -> dict:
    """``{path: leaf}`` with every sharded piece made whole again on every
    rank (a collective over 'model': every rank must call it). A leaf is
    a piece when the rule shards it and its rows times the 'model' axis are
    ``vocab_rows``; other leaves pass through."""
    out = {}
    for k, leaf in flat.items():
        spec = spec_for_path(k, leaf)
        if spec and torch.is_tensor(leaf) and vocab_sharded(
                mesh, leaf.shape[0], vocab_rows):
            leaf = mesh_lib.gather(mesh, leaf.detach(), MODEL_AXIS) \
                .reshape(-1, *leaf.shape[1:])
        out[k] = leaf
    return out


def gather_state(mesh: Mesh, tree: Any, vocab_rows: int) -> Any:
    """The inverse of :func:`shard_state` (a collective)."""
    return _unflatten(gather_flat(mesh, _flatten(tree), vocab_rows))
