"""Counter-based dropout bits shared by the fused encoder layer's CUDA
kernels and its plain PyTorch version.

The TPU kernels draw their masks from ``pltpu.prng_random_bits``, whose
stream no other device reproduces. The port replaces it with one fixed
32-bit integer hash over ``(key, counter)``, written twice bit for bit:
here in int64 tensor arithmetic masked to 32 bits, and as
``dropout_bits`` in ``csrc/fused_encoder_layer.cu``. So the kernel and
the plain version draw equal masks from equal seeds, on any device.

Law (the JAX kernel's ``_site_seed`` / ``_keep_scale``,
``bert4rec_tpu/ops/fused_encoder_layer.py:82-95``):

- ``key = seed + elem * SITES_PER_CELL + site`` (mod 2^32), where
  ``elem`` is the batch element and ``site`` is head ``h`` for the
  attention probabilities, ``N`` for the attention output and ``N + 1``
  for the FFN output;
- ``counter = row * n_cols + col`` inside that site's ``[rows, n_cols]``
  matrix;
- ``bits = fmix32(k ^ counter * 0x9E3779B9)`` with ``k = fmix32(key)``
  (murmur3's 32-bit finaliser): one round per element, since ``k`` is
  constant for a (batch element, site) and the kernels compute it once;
- kept where ``bits >= uint32(rate * 2^32)``, scaled by ``1 / (1 - rate)``.
"""

import torch

SITES_PER_CELL = 64
MASK32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_FMIX_C1 = 0x85EBCA6B
_FMIX_C2 = 0xC2B2AE35


def threshold(rate: float) -> int:
    """The keep threshold of ``_keep_scale``: ``uint32(rate * 2^32)``."""
    return min(int(rate * (2 ** 32)), 2 ** 32 - 1)


def keep_scale_value(rate: float) -> float:
    return 1.0 / (1.0 - rate)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for ``a`` in ``[0, 2^32)`` without int64
    overflow: the product is split at 16 bits."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX_C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX_C2)
    return h ^ (h >> 16)


def bits(key: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """The 32-bit hash of broadcastable int64 ``key`` and ``counter``
    tensors (values in ``[0, 2^32)``), as int64."""
    k = _fmix32(key & MASK32)
    return _fmix32(k ^ _mul32(counter, _GOLDEN))


def keep_scale(seed: int, batch: int, sites, rows: int, cols: int,
               rate: float, device, dtype=torch.float32) -> torch.Tensor:
    """``[batch, len(sites), rows, cols]``: ``1 / (1 - rate)`` where the
    element is kept, else 0."""
    elem = torch.arange(batch, dtype=torch.int64, device=device)
    site = torch.as_tensor(list(sites), dtype=torch.int64, device=device)
    key = (int(seed) + elem[:, None] * SITES_PER_CELL + site[None, :])
    counter = torch.arange(rows * cols, dtype=torch.int64,
                           device=device).view(rows, cols)
    kept = bits(key[:, :, None, None], counter[None, None]) >= threshold(rate)
    scale = torch.tensor(keep_scale_value(rate), dtype=torch.float32)
    return torch.where(kept, scale.to(device), 0.0).to(dtype)


# flash attention's bf16 kernels keep their probabilities' keep bits in
# 64 x 64 tile pairs of TILE_WORDS 32-bit words (csrc/flash_hopper.cuh)
TILE = 64
TILE_WORDS = 128


def tiles(seq_len: int) -> int:
    return -(-seq_len // TILE)


def tile_keep_bits(seed: int, batch: int, num_heads: int, seq_len: int,
                   rate: float, device) -> torch.Tensor:
    """The keep bits of flash attention's probabilities (site ``h`` per
    head, counter ``row * S + col``) as its bf16 forward kernel writes
    them: ``[B, N, T, T, 128]`` int32, ``T = tiles(S)``. Word
    ``32 w + 4 g + c`` of tile pair ``(qt, kt)`` holds at bit
    ``4 j + 2 h + e`` the pair (query ``64 qt + 16 w + g + 8 h``, key
    ``64 kt + 8 j + 2 c + e``): the elements of thread ``32 w + 4 g + c``
    of a ``wgmma`` accumulator. Pairs past the sequence hold their counter's
    bit too (``row * S + col`` mod 2^32)."""
    t = tiles(seq_len)
    pad = t * TILE
    elem = torch.arange(batch, dtype=torch.int64, device=device)
    site = torch.arange(num_heads, dtype=torch.int64, device=device)
    key = int(seed) + elem[:, None] * SITES_PER_CELL + site[None, :]
    idx = torch.arange(pad, dtype=torch.int64, device=device)
    counter = (idx[:, None] * seq_len + idx[None, :]) & MASK32
    kept = (bits(key[:, :, None, None], counter[None, None])
            >= threshold(rate)).to(torch.int64)
    # [B, N, qt, w, h, g, kt, j, c, e] -> [B, N, qt, kt, w, g, c, j, h, e]
    kept = kept.view(batch, num_heads, t, 4, 2, 8, t, 8, 4, 2).permute(
        0, 1, 2, 6, 3, 5, 8, 7, 4, 9)
    j, h, e = torch.meshgrid(*(torch.arange(n, device=device)
                               for n in (8, 2, 2)), indexing="ij")
    words = (kept << (4 * j + 2 * h + e)).sum(dim=(-3, -2, -1))
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.reshape(batch, num_heads, t, t, TILE_WORDS).to(torch.int32)


def fold_in(seed: int, data: int) -> int:
    """A new 31-bit seed from ``seed`` and ``data`` (the port's
    ``jax.random.fold_in``): every dropout seed of a train step derives
    from ``(seed, step)`` through it, so a resumed run draws the same
    masks."""
    k = bits(torch.tensor(int(seed) & MASK32), torch.tensor(int(data)
                                                            & MASK32))
    return int(k) & 0x7FFFFFFF
