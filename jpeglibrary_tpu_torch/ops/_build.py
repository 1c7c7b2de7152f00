"""On-first-use nvcc build of the port's CUDA kernels.

Every ``csrc/*.cu`` file compiles to an object, one nvcc process per
source, all started together; the objects link into one shared library
with a plain C interface, cached by a hash of the sources and flags under
the package's ``_build`` directory, and loaded with ctypes, the way
``host.native.build`` builds the scanner.
Nothing here runs at import: the library is built by the first kernel
launch, or by calling :func:`load_library`. The build runs under an
exclusive ``flock`` on a lock file in ``_build``, so the processes of one
machine compile once and the others load that library. A missing
``nvcc`` or a failed compile raises with the command line; there is no
fallback.
:func:`load_scanner` builds the host layers' native scanner the same way.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the build log
)
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_K1_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,  # coeffs, quant
    ctypes.c_void_p, ctypes.c_void_p,  # matrix, out
    ctypes.c_int64, ctypes.c_int64,    # n_blocks, blocks_per_table
    ctypes.c_int, ctypes.c_int,        # out_width, level_shift
    ctypes.c_void_p,                   # cudaStream_t
]
_K1_PLANE_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,  # coeffs, quant
    ctypes.c_void_p, ctypes.c_void_p,  # matrix, out
    ctypes.c_int64, ctypes.c_int64,    # n_blocks, blocks_per_table
    ctypes.c_int64,                    # width_blocks
    ctypes.c_int, ctypes.c_int,        # level_shift, max_sample
    ctypes.c_void_p,                   # cudaStream_t
]
_K2_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,  # plane, quant
    ctypes.c_void_p, ctypes.c_void_p,  # bf16 split of the matrix, out
    ctypes.c_int64, ctypes.c_int64,    # height, width (samples)
    ctypes.c_int64, ctypes.c_int64,    # height_blocks, width_blocks
    ctypes.c_int, ctypes.c_int,        # hs, vs
    ctypes.c_int,                      # level_shift
    ctypes.c_void_p,                   # cudaStream_t
]
_K2_WALK_ARGS = [ctypes.c_int] * 4  # sample bytes, hs, vs, level_shift
_K3_SHAPE_ARGS = [
    ctypes.c_void_p, ctypes.c_int64,   # segments, row width
    ctypes.c_int64, ctypes.c_int64,    # n_rows, n_sub
    ctypes.c_int64,                    # sub_bits
    ctypes.c_void_p, ctypes.c_int,     # comp_of, blocks per MCU
    ctypes.c_int,                      # n_comps
]
_K3_SYNC_ARGS = _K3_SHAPE_ARGS + [
    ctypes.c_void_p, ctypes.c_void_p,  # lookahead, maxcode
    ctypes.c_void_p, ctypes.c_void_p,  # valoffset, values
    ctypes.c_void_p, ctypes.c_void_p,  # starts, exits (two buffers)
    ctypes.c_void_p, ctypes.c_void_p,  # n_blk, dsum
    ctypes.c_void_p,                   # flag (device)
    ctypes.POINTER(ctypes.c_int),      # rounds (host)
    ctypes.c_void_p,                   # cudaStream_t
]
_K3_WRITE_ARGS = _K3_SHAPE_ARGS + [
    ctypes.c_void_p,                   # mcu_counts
    ctypes.c_void_p, ctypes.c_void_p,  # lookahead, maxcode
    ctypes.c_void_p, ctypes.c_void_p,  # valoffset, values
    ctypes.c_void_p, ctypes.c_void_p,  # starts, block0
    ctypes.c_void_p,                   # pred0
    ctypes.c_void_p, ctypes.c_int64,   # out, max_blocks
    ctypes.c_void_p,                   # cudaStream_t
]
_K4_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,  # coeffs, quant
    ctypes.c_void_p,                   # out
    ctypes.c_int64, ctypes.c_int64,    # n_blocks, width_blocks
    ctypes.c_int,                      # level_shift
    ctypes.c_void_p,                   # cudaStream_t
]
_K5_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,  # planes 0 and 1
    ctypes.c_void_p, ctypes.c_void_p,  # planes 2 and 3 (null past n_planes)
    ctypes.c_int,                      # n_planes
    ctypes.c_int64, ctypes.c_int64,    # batch, height_blocks
    ctypes.c_int64,                    # width_blocks
    ctypes.c_int, ctypes.c_int,        # the MCU's h, v
    ctypes.c_void_p, ctypes.c_void_p,  # n_valid, prev_dc (or null)
    ctypes.c_void_p,                   # out [2, 256]
    ctypes.c_void_p,                   # cudaStream_t
]
_K6_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p,  # y, cb samples
    ctypes.c_void_p, ctypes.c_void_p,  # cr samples, rgb
    ctypes.c_void_p, ctypes.c_void_p,  # y, cb planes
    ctypes.c_void_p,                   # cr plane
    ctypes.c_int64, ctypes.c_int64,    # mcu_rows, mcus_per_row
    ctypes.c_void_p,                   # constants (host)
    ctypes.c_void_p,                   # cudaStream_t
]
_ENTRY_POINTS = {
    "jpx_dequant_idct_i32": _K1_ARGS,
    "jpx_dequant_idct_i16": _K1_ARGS,
    "jpx_dequant_idct_plane_u16": _K1_PLANE_ARGS,
    "jpx_fdct_quant_i32": _K2_ARGS,
    "jpx_fdct_quant_u16": _K2_ARGS,
    "jpx_fdct_quant_u8": _K2_ARGS,
    "jpx_fdct_quant_walk": _K2_WALK_ARGS,
    "jpx_huffman_sync": _K3_SYNC_ARGS,
    "jpx_huffman_write": _K3_WRITE_ARGS,
    "jpx_butterfly_idct_i16": _K4_ARGS,
    "jpx_butterfly_idct_i32": _K4_ARGS,
    "jpx_symbol_histograms_i16": _K5_ARGS,
    "jpx_symbol_histograms_i32": _K5_ARGS,
    "jpx_color_round_trip": _K6_ARGS,
}


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``, then ``PATH``, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built"
    )


def build_library() -> pathlib.Path:
    """Compile the kernels if needed and return the library's path.

    The compilers' output (ptxas register and shared-memory report) is
    kept beside the library with the suffix ``.log``."""
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = _PKG / "_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    so_path = out_dir / f"libjpxcuda-{h.hexdigest()[:16]}.so"
    if so_path.exists():
        return so_path
    with open(so_path.with_name(f"{so_path.name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so_path.exists():
            _compile(sources, so_path)
    return so_path


def _compile(sources, so_path: pathlib.Path) -> None:
    nvcc = find_nvcc()
    tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
    objs = [so_path.with_name(f"{so_path.stem}-{src.stem}.{os.getpid()}.o") for src in sources]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    logs = [proc.communicate()[0] for proc in procs]  # waits for every compile
    try:
        for cmd, proc, out in zip(compiles, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n{out}")
        linked = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        if linked.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {linked.returncode}: {' '.join(link)}\n"
                f"{linked.stdout}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    so_path.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, so_path)


def load_scanner() -> ctypes.CDLL:
    """Build (once per source hash, with g++) and load the native entropy
    scanner of the port's host layers (``host/native``); raises if it
    cannot be built, so no image falls back to the Python scanner."""
    from ..host.native import build as native_build

    return native_build.load_library()


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, argtypes in _ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _LIB = lib
        return _LIB
