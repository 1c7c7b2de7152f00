"""On-demand build of the native scanner shared library.

The .so is compiled once per source hash into the package's _build
directory (or JPX_NATIVE_BUILD_DIR) and loaded with ctypes — no
pybind11 dependency, no install step.

The port's copy of ``jpeglibrary_tpu/native/build.py``; it builds the
port's own ``scanner.cpp`` into ``jpeglibrary_tpu_torch/host/native/_build``.
``JPX_NATIVE_BUILD_DIR``, when set, is read by both packages: a library
is named by the hash of its source, so the two share a file only when
their sources are equal, and then it is the same library. ctypes loads
each library with ``RTLD_LOCAL``, so the reference's scanner and this
one can be loaded in one process. Unlike the reference's, the compile
runs under an exclusive ``flock`` on a lock file beside the library, so
the processes of one machine (parallel test workers) compile it once,
into a temporary file before the atomic rename.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

_SRC = pathlib.Path(__file__).with_name("scanner.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_FAILED: Optional[Exception] = None


def _build_dir() -> pathlib.Path:
    env = os.environ.get("JPX_NATIVE_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).with_name("_build")


def build_library() -> pathlib.Path:
    """Compile (if needed) and return the shared-library path."""
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so_path = out_dir / f"libjpxscan-{digest}.so"
    if so_path.exists():
        return so_path
    # One compile per machine: processes that arrive while another
    # compiles wait on the lock and then load its library.
    with open(so_path.with_name(f"{so_path.name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so_path.exists():
            return so_path
        tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
        cmd = [
            "g++", "-std=c++17", "-O3", "-march=native", "-ffp-contract=off",
            "-fPIC", "-shared", "-pthread", "-o", str(tmp), str(_SRC),
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    return so_path


def load_library() -> ctypes.CDLL:
    """Build + load the scanner library (cached; raises on failure)."""
    global _LIB, _FAILED
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _FAILED is not None:
            raise _FAILED
        try:
            lib = ctypes.CDLL(str(build_library()))
        except Exception as exc:  # compiler missing, etc.
            _FAILED = ImportError(f"native scanner unavailable: {exc}")
            raise _FAILED
        _configure(lib)
        _LIB = lib
        return lib


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.jpx_decode_baseline_scan.restype = c.c_int32
    lib.jpx_decode_baseline_scan.argtypes = [
        c.c_void_p,                      # data
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int32,  # spans
        c.c_int64,                       # restart_interval
        c.c_int64, c.c_int64,            # mcus per line / column
        c.c_int32,                       # n_comps
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # comp_h, comp_v
        c.c_void_p, c.c_void_p,          # dc_blob, ac_blob
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),  # planes, plane_wb
        c.c_int32,                       # n_threads
    ]
    lib.jpx_decode_baseline_scan_region.restype = c.c_int32
    lib.jpx_decode_baseline_scan_region.argtypes = (
        lib.jpx_decode_baseline_scan.argtypes
        + [c.c_int64, c.c_int64]  # first_mcu, mcu_row_offset
    )
    lib.jpx_decode_transform_rgb.restype = c.c_int32
    lib.jpx_decode_transform_rgb.argtypes = [
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),  # planes, plane_wb
        c.c_void_p,                      # quants (n_comps x 64 int32, zz)
        c.c_int32,                       # n_comps
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # comp_h, comp_v
        c.c_int32, c.c_int32,            # max_h, max_v
        c.c_int64, c.c_int64,            # width, height
        c.c_int64, c.c_int64,            # mcus per line / column
        c.c_void_p,                      # zz_to_nat
        c.c_int32,                       # mode (0 gray / 1 ycbcr / 2 rgb)
        c.c_void_p,                      # out rgb8
        c.c_int32,                       # n_threads
    ]
    lib.jpx_decode_progressive_scan.restype = c.c_int32
    lib.jpx_decode_progressive_chains.restype = c.c_int32
    lib.jpx_decode_progressive_chains.argtypes = [
        c.c_void_p,                      # data
        c.c_int32,                       # n_scans
        c.POINTER(c.c_int64), c.POINTER(c.c_int64),   # span starts/ends (concat)
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),   # span offsets/counts
        c.POINTER(c.c_int64),            # restart_intervals
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),   # ss, se
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),   # ah, al
        c.POINTER(c.c_int32),            # gates
        c.c_void_p,                      # table blobs
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),  # planes, wbs
        c.POINTER(c.c_int64), c.POINTER(c.c_int64),   # hbcs, total_units
        c.c_int32,                       # n_threads
    ]
    lib.jpx_decode_progressive_scan.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int32,  # spans
        c.c_int64,                       # restart_interval
        c.c_int64, c.c_int64, c.c_int64, # total_units, mcus_per_line, hbc
        c.c_int32,                       # n_comps
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # comp_h, comp_v
        c.c_void_p, c.c_void_p,          # dc_blob, ac_blob
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),  # planes, plane_wb
        c.c_int32, c.c_int32, c.c_int32, c.c_int32,   # ss, se, ah, al
        c.c_int32,                       # n_threads
    ]
    lib.jpx_decode_lossless_scan.restype = c.c_int32
    lib.jpx_decode_lossless_scan.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int32,  # spans
        c.c_int64,                       # restart_interval
        c.c_int64, c.c_int64,            # mcus per line / column
        c.c_int32,                       # n_comps
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # comp_h, comp_v
        c.c_void_p,                      # table_blob
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),  # planes, widths
        c.c_int32, c.c_int32,            # predictor_sel, initial_prediction
    ]
    lib.jpx_decode_lossless_arith.restype = c.c_int32
    lib.jpx_decode_lossless_arith.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int32,  # spans
        c.c_int64,                       # restart_interval
        c.c_int64, c.c_int64,            # mcus per line / column
        c.c_int32,                       # n_comps
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # comp_h, comp_v
        c.POINTER(c.c_int32),            # table_ids
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # cond_lo, cond_hi
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),  # planes, widths
        c.c_int32, c.c_int32,            # predictor_sel, initial_prediction
    ]
    lib.jpx_decode_lossless_arith_restart_parallel.restype = c.c_int32
    lib.jpx_decode_lossless_arith_restart_parallel.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int32,  # spans
        c.c_int64,                       # restart_interval
        c.c_int64, c.c_int64,            # mcus per line / column
        c.c_int32,                       # n_comps
        c.POINTER(c.c_int32),            # table_ids
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # cond_lo, cond_hi
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),  # planes, widths
        c.c_int32, c.c_int32,            # predictor_sel, initial_prediction
        c.c_int32,                       # n_threads
    ]
    lib.jpx_encode_lossless_arith.restype = c.c_int64
    lib.jpx_encode_lossless_arith.argtypes = [
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),  # planes, widths
        c.c_int64, c.c_int64,            # mcus per line / column
        c.c_int32,                       # n_comps
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # comp_h, comp_v
        c.POINTER(c.c_int32),            # table_ids
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # cond_lo, cond_hi
        c.c_int32, c.c_int32, c.c_int32,  # predictor, init_pred, pt
        c.c_int64,                       # restart_interval
        c.c_void_p, c.c_int64,           # out, cap
    ]
    lib.jpx_encode_lossless_arith_restart_parallel.restype = c.c_int64
    lib.jpx_encode_lossless_arith_restart_parallel.argtypes = (
        lib.jpx_encode_lossless_arith.argtypes + [c.c_int32]  # + n_threads
    )
    lib.jpx_decode_lossless_restart_parallel.restype = c.c_int32
    lib.jpx_decode_lossless_restart_parallel.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int32,  # spans
        c.c_int64,                       # restart_interval
        c.c_int64, c.c_int64,            # mcus per line / column
        c.c_int32,                       # n_comps
        c.c_void_p,                      # table_blob
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),  # planes, widths
        c.c_int32, c.c_int32,            # predictor_sel, initial_prediction
        c.c_int32,                       # n_threads
    ]
    lib.jpx_decode_lossless_scan_parallel.restype = c.c_int32
    lib.jpx_decode_lossless_scan_parallel.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64,  # data, span_start, span_end
        c.c_int64, c.c_int64,            # mcus per line / column
        c.c_int32,                       # n_comps
        c.c_void_p,                      # table_blob
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),  # planes, widths
        c.c_int32, c.c_int32,            # predictor_sel, initial_prediction
        c.c_int32,                       # n_threads
    ]
    lib.jpx_decode_arithmetic_scan.restype = c.c_int32
    lib.jpx_decode_arithmetic_scan.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int32,  # spans
        c.c_int64,                       # restart_interval
        c.c_int64, c.c_int64, c.c_int64, # total_units, mcus_per_line, hbc
        c.c_int32,                       # n_comps
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # comp_h, comp_v
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # dc_ids, ac_ids
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # dc_l, dc_u, ac_kx
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),  # planes, plane_wb
        c.c_int32,                       # progressive
        c.c_int32, c.c_int32, c.c_int32, c.c_int32,   # ss, se, ah, al
        c.c_int32,                       # n_threads
    ]
    lib.jpx_set_qe_table.restype = None
    lib.jpx_set_qe_table.argtypes = [c.POINTER(c.c_int32)]
    from ..models.arithmetic import QE_TABLE

    qe = (c.c_int32 * 114)(*[v - 0x100000000 if v >= 0x80000000 else v for v in QE_TABLE])
    lib.jpx_set_qe_table(qe)
    lib._qe_keepalive = qe
    lib.jpx_decode_image_baseline_sparse.restype = c.c_int64
    lib.jpx_decode_image_baseline_sparse.argtypes = [
        c.c_void_p, c.c_int64,           # data, len
        c.c_void_p, c.c_int64,           # out, capacity (entries)
        c.c_void_p, c.c_void_p,          # info int32[16], quants u16[4][64]
        c.c_int32,                       # n_threads
    ]
    lib.jpx_decode_baseline_scan_sparse.restype = c.c_int64
    lib.jpx_decode_baseline_scan_sparse.argtypes = [
        c.c_void_p,                      # data
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int32,  # spans
        c.c_int64,                       # restart_interval
        c.c_int64, c.c_int64,            # mcus per line / column
        c.c_int32,                       # n_comps
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # comp_h, comp_v
        c.c_void_p, c.c_void_p,          # dc_blob, ac_blob
        c.c_void_p, c.c_int64,           # out, capacity (entries)
        c.c_int32,                       # n_threads
    ]
    lib.jpx_decode_image_baseline_sparse2.restype = c.c_int64
    lib.jpx_decode_image_baseline_sparse2.argtypes = [
        c.c_void_p, c.c_int64,           # data, len
        c.c_void_p, c.c_void_p, c.c_int64,  # dc_out, counts_out, nb_capacity
        c.c_void_p, c.c_void_p, c.c_int64,  # acpos, acval, ac_capacity
        c.c_void_p, c.c_int64, c.POINTER(c.c_int64),  # exc, cap, n_exc
        c.c_void_p, c.c_void_p,          # info int32[22], quants u16[4][64]
        c.c_int32,                       # n_threads
    ]
    lib.jpx_decode_baseline_scan_sparse2.restype = c.c_int64
    lib.jpx_decode_baseline_scan_sparse2.argtypes = [
        c.c_void_p,                      # data
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int32,  # spans
        c.c_int64,                       # restart_interval
        c.c_int64, c.c_int64,            # mcus per line / column
        c.c_int32,                       # n_comps
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # comp_h, comp_v
        c.c_void_p, c.c_void_p,          # dc_blob, ac_blob
        c.c_void_p, c.c_void_p,          # dc_out, counts_out
        c.c_void_p, c.c_void_p, c.c_int64,  # acpos, acval, ac_capacity
        c.c_void_p, c.c_int64, c.POINTER(c.c_int64),  # exc, cap, n_exc
        c.c_int32,                       # n_threads
    ]
    lib.jpx_pack_sparse.restype = c.c_int64
    lib.jpx_pack_sparse.argtypes = [
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64), c.c_int32,  # planes
        c.c_void_p, c.c_int64,           # out, capacity
    ]
    lib.jpx_box_subsample.restype = None
    lib.jpx_box_subsample.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64,  # in, h, w
        c.c_int32, c.c_int32,              # hs, vs
        c.c_void_p,                        # out
    ]
    lib.jpx_decode_rgb_fused.restype = c.c_int32
    lib.jpx_decode_rgb_fused.argtypes = [
        c.c_void_p,                      # data
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int32,  # spans
        c.c_int64,                       # restart_interval
        c.c_int64, c.c_int64,            # mcus per line / column
        c.c_int32,                       # n_comps
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # comp_h, comp_v
        c.c_void_p, c.c_void_p,          # dc_blob, ac_blob
        c.POINTER(c.c_void_p), c.POINTER(c.c_int64),  # planes, plane_wb
        c.c_void_p,                      # quants (n_comps x 64 int32, zz)
        c.c_int32, c.c_int32,            # max_h, max_v
        c.c_int64, c.c_int64,            # width, height
        c.c_void_p,                      # zz_to_nat
        c.c_int32,                       # mode (0 gray / 1 ycbcr / 2 rgb)
        c.c_void_p,                      # out rgb8
        c.c_int32,                       # n_threads
    ]
    lib.jpx_zz_block_permute.restype = None
    lib.jpx_zz_block_permute.argtypes = [
        c.c_void_p,                        # base (first element of view)
        c.c_int64, c.c_int64, c.c_int64,   # element strides s0, s1, s2
        c.c_int64, c.c_int64,              # hb, wb
        c.c_void_p, c.c_void_p,            # perm[64] i32, sign[64] i32
        c.c_void_p,                        # out int16 [hb, wb, 64]
        c.c_int32,                         # n_threads
    ]
    lib.jpx_rgb_to_ycbcr.restype = None
    lib.jpx_rgb_to_ycbcr.argtypes = [
        c.c_void_p, c.c_int64,           # rgb, n
        c.c_void_p, c.c_void_p, c.c_void_p,  # y, cb, cr
        c.POINTER(c.c_int32),            # constants
    ]
    lib.jpx_encode_transform_rgb.restype = None
    lib.jpx_encode_transform_rgb.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64,  # rgb, h, w
        c.c_int32, c.c_int32,              # max_h, max_v
        c.c_void_p, c.c_void_p, c.c_void_p,  # quant Y/Cb/Cr (f32 zz)
        c.c_void_p, c.POINTER(c.c_int32),  # zz_to_nat, color consts
        c.c_void_p, c.c_void_p, c.c_void_p,  # out Y/Cb/Cr (int16 MCU order)
        c.c_void_p,                        # hists int64[3*512] or None
        c.c_int32,                         # n_threads
    ]
    lib.jpx_pack_lossless_restart.restype = c.c_int64
    lib.jpx_pack_lossless_restart.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64,  # cats, raws, n
        c.c_int64,                          # step (entries/segment)
        c.c_void_p, c.c_int64,              # pattern, pattern_len
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # codes, sizes
        c.c_void_p, c.c_int64,              # out, capacity
        c.c_int32,                          # n_threads
    ]
    lib.jpx_lossless_diffs_hist.restype = c.c_int64
    lib.jpx_lossless_diffs_hist.argtypes = [
        c.c_void_p, c.c_void_p,             # p8, p16 (one non-null)
        c.c_int64, c.c_int64,               # h, w
        c.c_int32, c.c_int32, c.c_int32,    # pt, sel, init
        c.c_int64,                          # restart interval (px)
        c.c_void_p, c.c_void_p,             # diffs_out, hist
        c.c_int32,                          # n_threads
    ]
    lib.jpx_pack_lossless_diffs.restype = c.c_int64
    lib.jpx_pack_lossless_diffs.argtypes = [
        c.POINTER(c.c_void_p), c.c_int32, c.c_int64,  # diffs, n_comps, n_px
        c.c_int64,                          # restart interval (px)
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # codes, sizes
        c.c_void_p, c.c_int64,              # out, capacity
        c.c_int32,                          # n_threads
    ]
    lib.jpx_encode_arith_restart_parallel.restype = c.c_int64
    lib.jpx_encode_arith_restart_parallel.argtypes = [
        c.c_int32,
        c.POINTER(c.c_void_p), c.POINTER(c.c_int32),   # blocks, per_mcu
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),    # dc_ids, ac_ids
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # dc_l, dc_u, ac_kx
        c.c_int64, c.c_int64,              # n_mcus, restart_interval
        c.c_void_p, c.c_int64,             # out, capacity
        c.c_int32,                         # n_threads
    ]
    lib.jpx_encode_transform_cmyk.restype = None
    lib.jpx_encode_transform_cmyk.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64,  # ink, h, w
        c.c_int32, c.c_int32, c.c_int32,   # max_h, max_v, ycck
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # quants 0..3
        c.c_void_p, c.POINTER(c.c_int32),  # zz_to_nat, color consts
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # outs 0..3
        c.c_int32,                         # n_threads
    ]
    lib.jpx_encode_rgb_baseline.restype = c.c_int64
    lib.jpx_encode_rgb_baseline.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64,  # rgb, h, w
        c.c_int32, c.c_int32,              # max_h, max_v
        c.c_void_p, c.c_void_p, c.c_void_p,  # quant Y/Cb/Cr (f32 zz)
        c.c_void_p, c.POINTER(c.c_int32),  # zz_to_nat, color consts
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # dc codes/sizes [3]
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # ac codes/sizes [3]
        c.c_int64,                         # restart_interval
        c.c_void_p, c.c_int64,             # out, capacity
        c.c_int32,                         # n_threads
    ]
    lib.jpx_encode_rgb_band.restype = c.c_int64
    lib.jpx_encode_rgb_band.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64,  # rgb band, band_h, w
        c.c_int32, c.c_int32,              # max_h, max_v
        c.c_void_p, c.c_void_p, c.c_void_p,  # quants f32 zz (y, cb, cr)
        c.c_void_p, c.POINTER(c.c_int32),  # zz_to_nat, color consts
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # dc codes/sizes
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # ac codes/sizes
        c.POINTER(c.c_int64), c.c_int32,   # state[6], is_last
        c.c_void_p, c.c_int64,             # out, capacity
        c.c_int32,                         # n_threads
    ]
    lib.jpx_encode_cmyk_baseline.restype = c.c_int64
    lib.jpx_encode_cmyk_baseline.argtypes = [
        c.c_void_p, c.c_int64, c.c_int64,  # ink, h, w
        c.c_int32, c.c_int32, c.c_int32,   # max_h, max_v, ycck
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_void_p,  # quants 0-3 (f32 zz)
        c.c_void_p, c.POINTER(c.c_int32),  # zz_to_nat, color consts
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # dc codes/sizes [4]
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # ac codes/sizes [4]
        c.c_int64,                         # restart_interval
        c.c_void_p, c.c_int64,             # out, capacity
        c.c_int32,                         # n_threads
    ]
    lib.jpx_encode_segment.restype = c.c_int64
    lib.jpx_encode_segment.argtypes = [
        c.c_int32,
        c.POINTER(c.c_void_p), c.POINTER(c.c_int32),   # blocks, per_mcu
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # dc codes/sizes
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # ac codes/sizes
        c.c_int64,                       # n_mcus
        c.c_void_p, c.c_int64,           # out, capacity
    ]
    lib.jpx_encode_segment_parallel.restype = c.c_int64
    lib.jpx_encode_segment_parallel.argtypes = (
        lib.jpx_encode_segment.argtypes + [c.c_int32]  # + n_threads
    )
    lib.jpx_encode_segments_rst.restype = c.c_int64
    lib.jpx_encode_segments_rst.argtypes = [
        c.c_int32,
        c.POINTER(c.c_void_p), c.POINTER(c.c_int32),   # blocks, per_mcu
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # dc codes/sizes
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # ac codes/sizes
        c.c_int64, c.c_int64,            # n_mcus, restart interval
        c.c_void_p, c.c_int64,           # out, capacity
        c.c_int32,                       # n_threads
    ]
    lib.jpx_lossless_stream_open.restype = c.c_void_p
    lib.jpx_lossless_stream_open.argtypes = [
        c.c_void_p,                                   # data
        c.POINTER(c.c_int64), c.POINTER(c.c_int64), c.c_int32,  # spans
        c.c_int64,                                    # restart_interval
        c.c_int64, c.c_int64,                         # mcus per line/column
        c.c_int32,                                    # n_comps
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),   # comp h/v
        c.c_void_p,                                   # table blob
        c.POINTER(c.c_int64),                         # plane widths
        c.c_int32, c.c_int32,                         # predictor, init
    ]
    lib.jpx_lossless_stream_close.restype = None
    lib.jpx_lossless_stream_close.argtypes = [c.c_void_p]
    lib.jpx_lossless_stream_next.restype = c.c_int64
    lib.jpx_lossless_stream_next.argtypes = [
        c.c_void_p, c.c_int64, c.POINTER(c.c_void_p)
    ]
    lib.jpx_encode_segment_carry.restype = c.c_int64
    lib.jpx_encode_segment_carry.argtypes = (
        lib.jpx_encode_segment.argtypes
        + [
            c.POINTER(c.c_int32),   # predictors (in/out)
            c.POINTER(c.c_uint64),  # carry_reg (in/out)
            c.POINTER(c.c_int32),   # carry_bits (in/out)
            c.c_int32,              # finalize
        ]
    )
    lib.jpx_encode_prog_dc.restype = c.c_int64
    lib.jpx_encode_prog_dc.argtypes = [
        c.c_int32,
        c.POINTER(c.c_void_p), c.POINTER(c.c_int32),   # blocks, per_mcu
        c.c_int64,                       # n_mcus
        c.c_int32, c.c_int32,            # ah, al
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # dc codes/sizes
        c.POINTER(c.c_void_p),           # dc_freqs (count mode)
        c.c_void_p, c.c_int64,           # out, capacity
        c.c_int64,                       # restart interval (MCUs)
    ]
    for name in ("jpx_encode_prog_ac_first", "jpx_encode_prog_ac_refine"):
        fn = getattr(lib, name)
        fn.restype = c.c_int64
        fn.argtypes = [
            c.c_void_p, c.c_int64,           # blocks, n_blocks
            c.c_int32, c.c_int32, c.c_int32,  # ss, se, al
            c.c_void_p, c.c_void_p,          # ac codes/sizes
            c.c_void_p,                      # ac_freq (count mode)
            c.c_void_p, c.c_int64,           # out, capacity
            c.c_int64,                       # restart interval (blocks)
        ]
    lib.jpx_encode_arith_prog_dc.restype = c.c_int64
    lib.jpx_encode_arith_prog_dc.argtypes = [
        c.c_int32,
        c.POINTER(c.c_void_p), c.POINTER(c.c_int32),   # blocks, per_mcu
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # dc_ids/l/u
        c.c_int64, c.c_int32, c.c_int32,  # n_mcus, ah, al
        c.c_void_p, c.c_int64,           # out, capacity
        c.c_int64,                       # restart interval (MCUs)
    ]
    lib.jpx_encode_arith_prog_ac.restype = c.c_int64
    lib.jpx_encode_arith_prog_ac.argtypes = [
        c.c_void_p, c.c_int64,           # blocks, n_blocks
        c.c_int32, c.c_int32,            # ac_id, ac_kx
        c.c_int32, c.c_int32, c.c_int32, c.c_int32,  # ss, se, ah, al
        c.c_void_p, c.c_int64,           # out, capacity
        c.c_int64,                       # restart interval (blocks)
    ]
    lib.jpx_encode_arith_sequential.restype = c.c_int64
    lib.jpx_encode_arith_sequential.argtypes = [
        c.c_int32,
        c.POINTER(c.c_void_p), c.POINTER(c.c_int32),   # blocks, per_mcu
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),    # dc_ids, ac_ids
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # dc_l/dc_u/ac_kx
        c.c_int64,                       # n_mcus
        c.c_void_p, c.c_int64,           # out, capacity
    ]
    lib.jpx_pack_lossless.restype = c.c_int64
    lib.jpx_pack_lossless.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64,  # cats, raws, n
        c.c_void_p, c.c_int64,              # pattern, pattern_len
        c.POINTER(c.c_void_p), c.POINTER(c.c_void_p),  # codes, sizes
        c.c_void_p, c.c_int64,              # out, capacity
    ]
    lib.jpx_symbol_histograms.restype = c.c_int64
    lib.jpx_symbol_histograms.argtypes = [
        c.c_void_p, c.c_int64,           # blocks, n_blocks
        c.c_void_p, c.c_void_p,          # dc_freq, ac_freq (int64[256])
        c.c_int32,                       # n_threads
    ]
    lib.jpx_fdct_quantize.restype = None
    lib.jpx_fdct_quantize.argtypes = [
        c.c_void_p, c.c_void_p,          # plane_u8 / plane_i32
        c.c_int64, c.c_int64,            # h, w
        c.c_void_p, c.c_void_p,          # quant_zz (f32), zz_to_nat (u8)
        c.c_void_p,                      # out int16
        c.c_int32,                       # n_threads
        c.c_float,                       # level_shift (1 << (P-1))
    ]
