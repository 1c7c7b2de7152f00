"""K1 alone on one NVIDIA GPU, at the benchmark cells' block counts.

    python3 tools/k1_probe.py [--old PATH]

Builds ``jpeglibrary_tpu_torch/csrc/dequant_idct.cu`` and, with ``--old
PATH``, another source of the same C entries (the kernel before a change,
for example ``git show <commit>:jpeglibrary_tpu_torch/csrc/dequant_idct.cu``),
each into its own library under a temporary directory; prints ptxas's
registers, shared memory and spills for each K1 kernel; then times K1's
launches of each cell's step on seeded coefficients made on the card:

- ``recompress_16mp_b4``: the int32 block store (W = 64) on int16
  coefficients, the luma's 4 x 512 x 512 blocks and each chroma's
  4 x 256 x 256, level shift 128;
- ``recompress_imagenet_b256``: the luma's 256 x 48 x 64 blocks and each
  chroma's 256 x 24 x 32;
- ``recompress_ct12_b512``: the uint16 plane store on 512 x 64 x 64
  blocks in rows of 64, level shift 2048, samples clamped to 4095.

Kernel time from ``torch.profiler`` (``chip_smoke.kernel_ms``: mean of 25
calls in turns), warm and with the L2 flushed. Each time is printed with
its share of the bytes bound (int16 coefficients in, int32 or uint16
samples out, at 3.35 TB/s), of the FFMA floor (4,096 FFMA a block at
``chip_smoke.FP32_OPS_PER_S``) and its nanoseconds a block, and a step's
K1 time is the sum of its cell's launches. With ``--old`` every output of
the two libraries is compared byte for byte first, and any difference
exits non-zero.

Prints the card's name and power limit first. Exits non-zero without a
CUDA device. Writes nothing but temporary files.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (kernel_ms, the flush size, the peaks)
from jpeglibrary_tpu_torch.ops import _build, kernels  # noqa: E402

SOURCE = ROOT / "jpeglibrary_tpu_torch" / "csrc" / "dequant_idct.cu"
FFMA_PER_BLOCK = 64 * 64
# (cell, launch, launches a step, store, (batch, block rows, block columns),
#  level shift, max sample)
LAUNCHES = (
    ("recompress_16mp_b4", "luma", 1, "blocks", (4, 512, 512), 128, None),
    ("recompress_16mp_b4", "chroma", 2, "blocks", (4, 256, 256), 128, None),
    ("recompress_imagenet_b256", "luma", 1, "blocks", (256, 48, 64), 128, None),
    ("recompress_imagenet_b256", "chroma", 2, "blocks", (256, 24, 32), 128, None),
    ("recompress_ct12_b512", "slices", 1, "plane", (512, 64, 64), 2048, 4095),
    ("recompress_24mp_422_b4", "luma", 1, "blocks", (4, 500, 750), 128, None),
    ("recompress_24mp_422_b4", "chroma", 2, "blocks", (4, 500, 375), 128, None),
)


def build(sources, out_dir):
    """One library per named source, nvcc processes in parallel, as _build
    does; prints ptxas's lines for the K1 kernels."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{len(procs)}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"k1_probe: nvcc failed for {name}:\n{log}")
        kernel = None
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1] if "'" in ln else ln
            elif kernel and "dequant_idct" in kernel and ("registers" in ln or "spill" in ln):
                print(f"build: {name}: {kernel}: {ln.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(str(so))
        for entry in ("jpx_dequant_idct_i16", "jpx_dequant_idct_plane_u16"):
            getattr(lib, entry).argtypes = _build._ENTRY_POINTS[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def coefficients(shape, seed, device):
    """JPEG-like int16 coefficients [*shape, 64] made on the card (AC
    falling with frequency, DC over a 12-bit range) and an int32 quant
    table [64]."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = torch.randn((*shape, 64), generator=g, device=device) * 60
    c = c / (1 + torch.arange(64, device=device) / 8)
    c[..., 0] = torch.randint(-2000, 2000, shape, generator=g, device=device)
    quant = torch.randint(1, 64, (64,), generator=g, device=device, dtype=torch.int32)
    return c.round().to(torch.int16), quant


def launcher(lib, store, coeffs, quant, matrix, level_shift, top):
    """A call of ``lib``'s K1 on ``coeffs`` and its output tensor."""
    b, hb, wb = coeffs.shape[:3]
    n = b * hb * wb
    stream = torch.cuda.current_stream().cuda_stream
    if store == "blocks":
        out = torch.empty((n, 64), dtype=torch.int32, device=coeffs.device)

        def call():
            return lib.jpx_dequant_idct_i16(coeffs.data_ptr(), quant.data_ptr(), matrix.data_ptr(),
                                            out.data_ptr(), n, n, 64, level_shift, stream)
    else:
        out = torch.empty((b * hb * 8, wb * 8), dtype=torch.uint16, device=coeffs.device)

        def call():
            return lib.jpx_dequant_idct_plane_u16(
                coeffs.data_ptr(), quant.data_ptr(), matrix.data_ptr(), out.data_ptr(), n, n, wb,
                level_shift, top, stream)
    return call, out


def shares(n_blocks, out_bytes, ms):
    """(share of the bytes bound, share of the FFMA floor, ns a block)."""
    bytes_ms = n_blocks * 64 * (2 + out_bytes) / chip_smoke.HBM_BYTES_PER_S * 1e3
    ffma_ms = n_blocks * 2 * FFMA_PER_BLOCK / chip_smoke.FP32_OPS_PER_S * 1e3
    return bytes_ms / ms, ffma_ms / ms, ms * 1e6 / n_blocks


def run(libs, device, flush, launches=LAUNCHES):
    """Check (with two libraries) and time each launch; print a line per
    launch, library and mode and a step's sums; return {(cell, lib, mode):
    step ms}."""
    matrix = kernels.transform_matrix(device)
    steps = {}
    for i, (cell, what, per_step, store, shape, ls, top) in enumerate(launches):
        coeffs, quant = coefficients(shape, 2100 + i, device)
        calls = {name: launcher(lib, store, coeffs, quant, matrix, ls, top)
                 for name, lib in libs.items()}
        n = coeffs.numel() // 64
        label = f"{cell} {what} [{', '.join(map(str, shape))}] int16 -> {store}"
        outs = []
        for name, (call, out) in calls.items():
            err = call()
            if err:
                raise SystemExit(f"k1_probe: {name}: launch failed with CUDA error {err}")
            torch.cuda.synchronize()
            outs.append(out.clone())
        if len(outs) > 1:
            same = all(torch.equal(outs[0], o) for o in outs[1:])
            print(f"check: {label}: outputs {'equal' if same else 'DIFFER'} byte for byte "
                  f"({' / '.join(calls)})", flush=True)
            if not same:
                raise SystemExit("k1_probe: the libraries' outputs differ")
        out_bytes = 4 if store == "blocks" else 2
        for mode, kwargs in (("warm", {}), ("L2 flushed", {"flush": flush})):
            times = chip_smoke.kernel_ms(*(call for call, _ in calls.values()), **kwargs)
            for name, ms in zip(calls, times):
                by_bytes, by_ffma, ns = shares(n, out_bytes, ms)
                print(f"time: {label}, {mode}: {name} {ms:.6f} ms, {ns:.4f} ns a block, "
                      f"{by_bytes:.1%} of the bytes bound, {by_ffma:.1%} of the FFMA floor "
                      f"(kernel time, mean of {chip_smoke.TIMED_RUNS} in turns)", flush=True)
                steps[(cell, name, mode)] = steps.get((cell, name, mode), 0.0) + per_step * ms
    for (cell, name, mode), ms in steps.items():
        print(f"step: {cell}, {mode}: {name}: K1 {ms:.6f} ms a step")
    return steps


def main(argv=None):
    parser = argparse.ArgumentParser(description="K1 alone, timed on one GPU.")
    parser.add_argument("--old", type=pathlib.Path,
                        help="also build, check against and time this source of the kernel")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    device = torch.device("cuda")
    sources = {"new": SOURCE.read_text()}
    if args.old is not None:
        sources = {"old": args.old.read_text(), **sources}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, pathlib.Path(tmp))
        flush = torch.empty(chip_smoke.FLUSH_BYTES, dtype=torch.uint8, device=device)
        run(libs, device, flush)


if __name__ == "__main__":
    main()
