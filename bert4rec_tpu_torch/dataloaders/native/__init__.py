"""Native (C++) masking engine of the host pipeline (port of
``bert4rec_tpu/dataloaders/native/__init__.py``).

``masking.cpp`` is a byte-for-byte copy of the JAX package's source (a CPU
test compares the two files), so both packages draw the same masks from
the same seed. ``load()`` compiles it with the system ``g++`` on first use
into ``_build/libmasking-<hash of the source>.so`` beside it (git-ignored;
an edited source rebuilds) and binds it with ctypes. Without a compiler
``available()`` is false and callers use the numpy engine, which draws the
same distribution from another random stream.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR / "masking.cpp"
BUILD_DIR = _DIR / "_build"

_lock = threading.Lock()
_lib = None
_load_failed = False


def _lib_path() -> pathlib.Path:
    sha = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmasking-{sha}.so"


def _compile(out: pathlib.Path) -> bool:
    """g++ into a private temporary file, then an atomic rename: a process
    compiling at the same time (another test worker) sees all of the
    library or none of it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def load() -> Optional[ctypes.CDLL]:
    """The compiled library, building it on first call (None on failure)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = _lib_path()
        if not path.is_file() and not _compile(path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _load_failed = True
            return None
        lib.apply_dynamic_masking_batch.restype = None
        lib.apply_dynamic_masking_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # in arrays
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,       # n, s, p
            ctypes.c_int32,                                       # mask id
            ctypes.c_void_p, ctypes.c_int64,                      # specials
            ctypes.c_int32,                                       # vocab
            ctypes.c_double, ctypes.c_double, ctypes.c_double,    # rates
            ctypes.c_uint64, ctypes.c_int32,                      # seed, thr
            ctypes.c_void_p, ctypes.c_void_p,                     # outputs
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def apply_dynamic_masking_batch_native(
        input_ids: np.ndarray,
        lengths: np.ndarray,
        max_selections_per_seq: int,
        mask_token_id: int,
        special_token_ids,
        vocab_size: int,
        seed: int,
        selection_rate: float = 0.2,
        mask_token_rate: float = 1.0,
        random_token_rate: float = 0.0,
        finetuning: Optional[np.ndarray] = None,
        n_threads: int = 0) -> dict:
    """Same contract as dataloader_utils.apply_dynamic_masking_batch, with
    an explicit integer ``seed`` (per-row splitmix64 streams; a given
    (seed, row) is deterministic regardless of threading)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native masking library unavailable")

    input_ids = np.ascontiguousarray(input_ids, dtype=np.int32)
    n, s = input_ids.shape
    p = max_selections_per_seq
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    specials = np.ascontiguousarray(
        np.asarray(list(special_token_ids), dtype=np.int32))
    ft = (np.ascontiguousarray(finetuning, dtype=np.uint8)
          if finetuning is not None else None)

    masked_input = np.empty_like(input_ids)
    mlm_positions = np.empty((n, p), dtype=np.int32)
    mlm_ids = np.empty((n, p), dtype=np.int32)
    mlm_weights = np.empty((n, p), dtype=np.int32)

    lib.apply_dynamic_masking_batch(
        input_ids.ctypes.data, lengths.ctypes.data,
        ft.ctypes.data if ft is not None else None,
        n, s, p, mask_token_id,
        specials.ctypes.data, len(specials), vocab_size,
        float(selection_rate), float(mask_token_rate),
        float(random_token_rate),
        np.uint64(seed & 0xFFFFFFFFFFFFFFFF), int(n_threads),
        masked_input.ctypes.data, mlm_positions.ctypes.data,
        mlm_ids.ctypes.data, mlm_weights.ctypes.data)

    return {
        "input_word_ids": masked_input,
        "masked_lm_positions": mlm_positions,
        "masked_lm_ids": mlm_ids,
        "masked_lm_weights": mlm_weights,
    }
