"""Path-keyed npz checkpoints (port of ``bert4rec_tpu/utils/checkpoint.py``).

Every array leaf of a nested param dict is stored in one ``.npz`` under its
``/``-joined path, e.g. ``encoder/layers/layer_0/attention/qkv/kernel`` —
the JAX package's format, so weights carry across in both directions.

A train state's seed crosses as JAX's ``rng`` (``rng_key_data`` /
``seed_from_key_data``): JAX stores ``key_data(jax.random.key(seed))``,
which with its defaults (threefry, 64-bit mode off) is ``[0, seed mod
2**32]`` as uint32, so a seed's high 32 bits do not survive JAX's key.
"""

import os
import pathlib
import tempfile
from typing import Dict

import numpy as np
import torch

from bert4rec_tpu_torch.core.device import resolve_device

_SEP = "/"


def rng_key_data(seed: int) -> np.ndarray:
    """The ``rng`` leaf JAX's trainer saves for ``jax.random.key(seed)``:
    uint32 ``[0, seed mod 2**32]`` (threefry key data, 64-bit mode off)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=np.uint32)


def seed_from_key_data(data) -> int:
    """The seed a two-word threefry key stands for: ``hi << 32 | lo``.
    Raises ValueError on key data of another shape or type (e.g. the four
    words of the 'rbg' PRNG): no seed is guessed from it."""
    data = np.asarray(data)
    if data.shape != (2,) or data.dtype != np.uint32:
        raise ValueError(f"rng key data of shape {data.shape} and dtype "
                         f"{data.dtype} is not a threefry key ([2] uint32); "
                         f"the port cannot take a seed from it")
    return int(data[0]) << 32 | int(data[1])


def flatten(tree: dict, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> ``{path: leaf}``."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(flatten(value, path))
        else:
            flat[path] = value
    return flat


def unflatten(flat: Dict[str, object]) -> dict:
    """``{path: leaf}`` -> nested dict."""
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split(_SEP)
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def params_from_numpy(flat: Dict[str, np.ndarray], device="cuda") -> dict:
    """The carry-across function: the JAX package's params as path-keyed
    numpy arrays (an npz's contents, or a flattened JAX pytree) -> the
    port's nested dict of tensors on ``device``. The layouts are the same,
    so this only converts."""
    device = resolve_device(device)
    return unflatten({k: torch.from_numpy(np.array(v, copy=True)).to(device)
                      for k, v in flat.items()})


def params_to_numpy(params: dict) -> Dict[str, np.ndarray]:
    """The port's params -> path-keyed numpy arrays (host copies)."""
    return {k: v.detach().cpu().numpy() for k, v in flatten(params).items()}


def save_pytree(path, tree: dict, mesh=None, vocab_rows: int = 0) -> None:
    """Save every tensor or array leaf of ``tree`` to ``path`` (``.npz``),
    atomically (a temporary file in the same directory, then a rename).

    With a ``mesh`` (JAX's multi-process save) the tree is this rank's
    pieces: the vocab-sharded leaves (``vocab_rows`` rows whole) are
    gathered first, a collective every rank joins; only world rank 0
    writes, and every rank waits until the file is in place."""
    path = pathlib.Path(path)
    flat = flatten(tree)
    if mesh is not None:
        from bert4rec_tpu_torch.core import mesh as mesh_lib
        from bert4rec_tpu_torch.core import partitioning
        flat = partitioning.gather_flat(mesh, flat, vocab_rows)
        if mesh.rank != 0:
            mesh_lib.barrier(mesh)
            return
    leaves = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in flat.items()}
    try:
        _write_npz(path, leaves)
    finally:
        if mesh is not None:
            mesh_lib.barrier(mesh)


def _write_npz(path: pathlib.Path, leaves: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **leaves)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_npz(path) -> Dict[str, np.ndarray]:
    """The path-keyed arrays of a checkpoint written by either package."""
    path = pathlib.Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"No checkpoint file at {path}")
    with np.load(path, allow_pickle=False) as data:
        return dict(data)


def check_structure(flat: Dict[str, np.ndarray], target: dict,
                    source="checkpoint") -> None:
    """Raise unless ``flat`` holds every leaf of ``target`` (a param dict,
    e.g. on the meta device) with its shape."""
    for key, leaf in flatten(target).items():
        if key not in flat:
            raise KeyError(f"{source} is missing leaf {key!r}; it has "
                           f"{sorted(flat)[:8]}...")
        if tuple(flat[key].shape) != tuple(leaf.shape):
            raise ValueError(f"{source} leaf {key!r} has shape "
                             f"{tuple(flat[key].shape)}, expected "
                             f"{tuple(leaf.shape)}")


def load_pytree(path, target: dict) -> dict:
    """Restore a tree saved by :func:`save_pytree` into ``target``'s
    structure: a tensor leaf of ``target`` becomes a tensor on that leaf's
    device with the stored values and dtype (keeping its
    ``requires_grad``); any other leaf becomes the stored numpy value
    (0-d arrays as Python scalars)."""
    stored = load_npz(path)
    out = {}
    for key, leaf in flatten(target).items():
        if key not in stored:
            raise KeyError(f"Checkpoint {path} is missing leaf {key!r}; it "
                           f"has {sorted(stored)[:8]}...")
        value = stored[key]
        if isinstance(leaf, torch.Tensor):
            t = torch.from_numpy(np.array(value, copy=True)).to(leaf.device)
            out[key] = t.requires_grad_(leaf.requires_grad)
        else:
            out[key] = value.item() if value.ndim == 0 else value
    return unflatten(out)
