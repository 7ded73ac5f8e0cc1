"""Host-side layout helpers of the checkpoint loader (counterpart of
``tpu_lutvq.utils.native``): ctypes bindings of the port's native library
``csrc/lutvq_pack.cpp``, built on first use with g++, and numpy branches
that give the same results bit for bit where it cannot be built.

The library is compiled with ``-O3 -fPIC -shared -std=c++17`` (and
``-fopenmp`` where the compiler takes it) into ``build/native/`` at the
checkout root (listed in ``.gitignore``); its file name carries a hash of
the source and flags, so an edited source rebuilds.  Nothing is built at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "lutvq_pack.cpp"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
ABI_VERSION = 1
_lib: Optional[ctypes.CDLL] = None
_tried = False


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "native"


def _openmp(cxx: str) -> list:
    """``["-fopenmp"]`` where the compiler takes it, as ``csrc/Makefile`` asks."""
    try:
        subprocess.run([cxx, "-fopenmp", "-x", "c++", "-", "-o", os.devnull],
                       input=b"int main(){}", capture_output=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return []
    return ["-fopenmp"]


def _build() -> Path:
    """Compile the library (once per source and flags) and return its path."""
    cxx = os.environ.get("CXX", "g++")
    flags = list(CXXFLAGS) + _openmp(cxx)
    tag = hashlib.sha1(SOURCE.read_bytes() + " ".join([cxx] + flags).encode()).hexdigest()[:12]
    path = build_dir() / f"liblutvq_pack-{tag}.so"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        try:
            subprocess.run([cxx, *flags, "-o", tmp, str(SOURCE)], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, path)  # concurrent processes each land a whole file
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path


def _declare(lib: ctypes.CDLL) -> None:
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    f32p, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
    lib.lutvq_abi_version.argtypes = []
    lib.lutvq_abi_version.restype = ctypes.c_int
    lib.lutvq_transpose_u8.argtypes = [u8p, u8p, i64, i64]
    lib.lutvq_transpose_u8.restype = None
    lib.lutvq_dequant_additive.argtypes = [i32p, f32p, f32p, f32p] + [i64] * 5
    lib.lutvq_dequant_additive.restype = None
    lib.lutvq_shard_repack_u8.argtypes = [u8p, u8p] + [i64] * 4 + [ctypes.c_uint8]
    lib.lutvq_shard_repack_u8.restype = None


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None where it cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.SubprocessError):
        return None
    _declare(lib)
    if lib.lutvq_abi_version() == ABI_VERSION:
        _lib = lib
    return _lib


def have_native() -> bool:
    return _load() is not None


def _ptr(a: Optional[np.ndarray], ct):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ct))


def pack_nibbles_np(codes: np.ndarray) -> np.ndarray:
    """``(..., 2L)`` uint8 4-bit values → ``(..., L)`` packed bytes, the
    even index in the low nibble."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    return (codes[..., 0::2] & 0xF) | ((codes[..., 1::2] & 0xF) << 4)


def unpack_nibbles_np(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_nibbles_np`."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    out = np.stack([packed & 0xF, packed >> 4], axis=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def transpose_u8(a: np.ndarray) -> np.ndarray:
    """``(rows, cols)`` uint8 → contiguous ``(cols, rows)``: the load-time
    ``codes_t`` transposition, cache-blocked in the native library."""
    a = np.ascontiguousarray(a, dtype=np.uint8)
    rows, cols = a.shape
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(a.T)
    out = np.empty((cols, rows), np.uint8)
    lib.lutvq_transpose_u8(_ptr(a, ctypes.c_uint8), _ptr(out, ctypes.c_uint8), rows, cols)
    return out


def dequant_additive(
    codes: np.ndarray,  # (d_out, M, N) unsigned values (any int dtype)
    codebook: np.ndarray,  # (N, K, g) float32
    scales: Optional[np.ndarray] = None,  # (d_out,)
) -> np.ndarray:
    """Load-time dequant of additive-VQ weights (the AQLM 1x16 path):
    ``w[o, m·g + j] = s[o] · Σ_n codebook[n, codes[o, m, n], j]``, summed in
    f32 from zero in codebook order, then scaled (the native library for
    ``g ≤ 64``)."""
    d_out, m, n = codes.shape
    if codebook.shape[0] != n:
        raise ValueError(f"codes {codes.shape} and codebook {codebook.shape} disagree on N")
    k, g = codebook.shape[1:]
    codes_i = np.ascontiguousarray(codes, dtype=np.int32)
    cb = np.ascontiguousarray(codebook, dtype=np.float32)
    lib = _load() if g <= 64 else None  # the library sums ≤ 64 entries a row
    if lib is not None:
        sc = None if scales is None else np.ascontiguousarray(scales, np.float32)
        out = np.empty((d_out, m * g), np.float32)
        lib.lutvq_dequant_additive(
            _ptr(codes_i, ctypes.c_int32), _ptr(cb, ctypes.c_float), _ptr(sc, ctypes.c_float),
            _ptr(out, ctypes.c_float), d_out, m, n, k, g,
        )
        return out
    w = np.zeros((d_out, m, g), np.float32)
    for nn in range(n):
        w += cb[nn][codes_i[:, :, nn]]
    out = w.reshape(d_out, m * g)
    if scales is not None:
        out = out * np.asarray(scales, np.float32)[:, None]
    return out


def shard_repack_u8(
    a: np.ndarray, local: int, local_pad: int, shards: int, fill: int = 0
) -> np.ndarray:
    """``(rows, local·shards)`` → ``(rows, local_pad·shards)``: each shard's
    chunk of columns padded at its end with ``fill``."""
    a = np.ascontiguousarray(a, dtype=np.uint8)
    rows = a.shape[0]
    if a.shape[1] != local * shards or local_pad < local:
        raise ValueError(f"{a.shape} is not {shards} chunks of {local} columns (pad {local_pad})")
    lib = _load()
    if lib is None:
        chunks = [np.pad(a[:, s * local:(s + 1) * local], ((0, 0), (0, local_pad - local)),
                         constant_values=fill) for s in range(shards)]
        return np.concatenate(chunks, axis=1)
    out = np.empty((rows, local_pad * shards), np.uint8)
    lib.lutvq_shard_repack_u8(_ptr(a, ctypes.c_uint8), _ptr(out, ctypes.c_uint8), rows, local,
                              local_pad, shards, fill)
    return out
