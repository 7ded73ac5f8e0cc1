"""Build and load the port's CUDA kernels.

The ``csrc/*.cu`` sources have a plain C interface.  On first use each is
compiled with its own ``nvcc`` for ``sm_90a``, all at once, and the objects
are linked into one shared library loaded with ``ctypes``.  The library's
file name carries a hash of the sources and flags, so an unchanged tree
reuses it and an edited one rebuilds; nvcc's report (registers, spills)
is kept beside it.  It lives
under ``build/kernels/`` at the checkout root (listed in ``.gitignore``), or
under ``$TPU_LUTVQ_TORCH_BUILD_DIR``.  Nothing here runs at import time, and
a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

DEFAULT_CUDA_HOME = "/usr/local/cuda"

_lib = None
BUILD_SECONDS = None  # wall time of the first ``library()`` call (build or load)
BUILD_LOG = ""  # nvcc's output (register, shared-memory and spill report) of this library


def build_dir() -> Path:
    env = os.environ.get("TPU_LUTVQ_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    homes = [os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME]
    cands = [shutil.which("nvcc")] + [str(Path(h) / "bin" / "nvcc") for h in homes if h]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are compiled on first use"
    )


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lutvq_lut_scan.argtypes = [i32] + [vp] * 4 + [i32] * 13 + [vp]
    lib.lutvq_lut_scan.restype = i32
    lib.lutvq_lut_scan_clusters.argtypes = [i32] * 8
    lib.lutvq_lut_scan_clusters.restype = i32
    lib.lutvq_lut_nibbles_bf16.argtypes = [vp] * 4 + [i32] * 9 + [vp]
    lib.lutvq_lut_nibbles_bf16.restype = i32
    lib.lutvq_lut_nibbles_bf16_clusters.argtypes = [i32] * 4
    lib.lutvq_lut_nibbles_bf16_clusters.restype = i32
    lib.lutvq_lut_nibbles_f32.argtypes = [vp] * 4 + [i32] * 9 + [vp]
    lib.lutvq_lut_nibbles_f32.restype = i32
    lib.lutvq_lut_nibbles_f32_clusters.argtypes = [i32] * 3
    lib.lutvq_lut_nibbles_f32_clusters.restype = i32
    lib.lutvq_dequant_mm.argtypes = [vp] * 6 + [i32] * 11 + [vp]
    lib.lutvq_dequant_mm.restype = i32
    lib.lutvq_dequant_mm_i8.argtypes = [vp] * 6 + [i32] * 12 + [vp]
    lib.lutvq_dequant_mm_i8.restype = i32
    lib.lutvq_fold_i8.argtypes = [vp] * 4 + [i32] * 6 + [vp]
    lib.lutvq_fold_i8.restype = i32
    lib.lutvq_lut_bpair.argtypes = [vp] * 4 + [i32] * 10 + [vp]
    lib.lutvq_lut_bpair.restype = i32
    lib.lutvq_lut_bpair_clusters.argtypes = [i32] * 4
    lib.lutvq_lut_bpair_clusters.restype = i32
    lib.lutvq_dequant_mm_f32.argtypes = [vp] * 6 + [i32] * 12 + [vp]
    lib.lutvq_dequant_mm_f32.restype = i32
    lib.lutvq_flash_decode.argtypes = [vp] * 9 + [i32] * 10 + [ctypes.c_float, vp]
    lib.lutvq_flash_decode.restype = i32
    lib.lutvq_flash_prefill.argtypes = [vp] * 7 + [i32] * 11 + [ctypes.c_float, vp]
    lib.lutvq_flash_prefill.restype = i32
    lib.lutvq_flash_prefill_clusters.argtypes = [i32] * 4
    lib.lutvq_flash_prefill_clusters.restype = i32
    lib.lutvq_error_string.argtypes = [i32]
    lib.lutvq_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this tree has none."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    srcs = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in srcs:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    out = build_dir() / f"libtpu_lutvq_kernels_{digest.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")  # nvcc's report, kept beside the library
    if not out.exists():
        nvcc = _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        objs = tmp.with_suffix(".objs")
        objs.mkdir(parents=True, exist_ok=True)
        try:
            BUILD_LOG = _run_all([
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs / f"{f.stem}.o"), str(f)]
                for f in srcs
            ])
            BUILD_LOG += _run_all([
                [nvcc, "-shared", "-o", str(tmp), *(str(objs / f"{f.stem}.o") for f in srcs)]
            ])
        finally:
            shutil.rmtree(objs, ignore_errors=True)
        log.write_text(BUILD_LOG)
        os.replace(tmp, out)
    elif log.exists():
        BUILD_LOG = log.read_text()
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    BUILD_SECONDS = time.perf_counter() - t0
    _lib = lib
    return lib


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; their output, or raise on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {p.returncode}: {' '.join(cmd)}\n{o}")
    return "".join(outs)


def stream_ptr(t: torch.Tensor) -> int:
    """Raw handle of torch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.lutvq_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def require_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Validate what a kernel is handed before its pointer crosses into C."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
