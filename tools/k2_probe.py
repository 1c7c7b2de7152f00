"""K2 alone on one NVIDIA GPU: the cells' launches, the kernel table's
shapes, the parts of the kernel and a per-warp timeline.

    python3 tools/k2_probe.py [--old PATH]

Builds ``jpeglibrary_tpu_torch/csrc/fdct_quant.cu`` and variants of it with
one part cut out by a text substitution (the product's MMAs; the IEEE
division, replaced by a multiply; the whole product and epilogue; the
conversion as well), each into its own library under a temporary
directory, and prints ptxas's registers, shared memory and spills for each
K2 kernel. With ``--old PATH`` it also builds another source of the same C
entries (the kernel before a change, for example ``git show
<commit>:jpeglibrary_tpu_torch/csrc/fdct_quant.cu``), compares every output
of the two byte for byte first and exits non-zero on any difference.

Then it times, by ``torch.profiler`` kernel time with the L2 flushed
(``chip_smoke.kernel_ms``: the mean of 25 calls in turns):

- the cells' launches (``CELLS``): each K2 launch of a step of
  ``recompress_16mp_b4``, ``recompress_imagenet_b256`` and
  ``recompress_ct12_b512``, on seeded planes made on the card, with every
  variant and one PyTorch copy of the plane to int16 beside them;
- the kernel table's shapes (``TABLE``): 2048 x 2048 planes at uint8 1x1
  and 2x2, int32 1x1 at level shift 2048, and the 3x1, 1x3, 3x3, 4x3 and
  4x4 boxes in uint8 and int32, the whole kernel only.

Each time is printed with its share of K2's bound (``chip_smoke.k2_bound``)
and a step's K2 time is the sum of its cell's launches. Last, a per-warp
timeline of the whole kernel on the flushed 16.8 MP luma: ``%globaltimer``
stamps by lane 0 of each warp at the start and, for each tile, when its
half strip's bytes have landed, after its conversion, after its product and
after its quantization, summarised as medians over the warps. The variants compute wrong
coefficients; they only time the parts.

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

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (kernel_ms, the flush size, K2's bound)
from jpeglibrary_tpu_torch.ops import _build, kernels  # noqa: E402

SOURCE = ROOT / "jpeglibrary_tpu_torch" / "csrc" / "fdct_quant.cu"
_SWEEPS = ("    if constexpr (G::kTwoA) sweep_group(a_lo, acc[0], b_tiles);\n"
           "    sweep_group(a_hi, acc[0], b_tiles);\n")
_SKIP_PRODUCT = (_SWEEPS, "    if (level_shift == 12345) {\n" + _SWEEPS + "    }\n")
_QUANTIZE = "    quantize_tile(acc, quant_s, out_s, lane);\n"
_CONVERT = "    convert_fragments<SampleT, HS, VS, G::kTwoA, G::kHalfRowBytes>("
CUT = {  # variant: [(text in the source, its replacement)]
    "whole kernel": [],
    "no MMAs": [("      wgmma_bf16(acc, a[kk], b_descriptor(",
                 "      if (0) wgmma_bf16(acc, a[kk], b_descriptor(")],
    "multiply for divide": [
        ("__fdiv_rn(acc[m][j][2 * half], q[j][0])", "(acc[m][j][2 * half] * q[j][0])"),
        ("__fdiv_rn(acc[m][j][2 * half + 1], q[j][1])", "(acc[m][j][2 * half + 1] * q[j][1])")],
    # The A fragments go into the output tile, so the conversion stays.
    "no product or epilogue": [
        _SKIP_PRODUCT,
        (_QUANTIZE, "    if (level_shift == 12345) {\n  " + _QUANTIZE + "    } else {\n"
         "      uint32_t x = 0;\n      for (int kk = 0; kk < 4; ++kk)\n"
         "        for (int e = 0; e < 4; ++e) {\n          x ^= a_hi[kk][e];\n"
         "          if constexpr (G::kTwoA) x ^= a_lo[kk][e];\n        }\n"
         "      reinterpret_cast<uint32_t*>(out_s)[lane] = x;\n    }\n")],
    "copies and stores only": [
        _SKIP_PRODUCT,
        (_QUANTIZE, "    if (level_shift == 12345) " + _QUANTIZE.lstrip()),
        (_CONVERT, "    if (level_shift == 12345) " + _CONVERT.lstrip())],
}
# The timeline: stamps into a __device__ array, read back by a C function.
_STAMPS = 40  # per warp: the start, then 4 stamps for each of the first 9 tiles
_STAMP = "    if (lane == 0 && it < 9) T[{} + it * 4] = stamp();\n"
_LANDED = "    __syncwarp();  // every lane's copies; the last half's slot and tile are free\n"
_CONVERTED = "    float acc[1][8][4] = {};\n"
_MULTIPLIED = "    asm volatile(\"wgmma.wait_group.sync.aligned 0;\\n\" ::: \"memory\");\n"
_QUANTIZED = "    __syncwarp();\n    const unsigned strip = 2 * tile + pair;\n"
TIMELINE = [
    ("namespace {\n", "namespace {\n__device__ long long g_stamp[4096 * 40];\n"
     "__device__ __forceinline__ long long stamp() {\n  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"),
    ("  int slot = 0;  // the ring slot of this iteration's half strip\n",
     "  int slot = 0;  // the ring slot of this iteration's half strip\n"
     "  long long* T = g_stamp + (blockIdx.x * G::kGroups * 4 + warp) * 40;\n"
     "  if (lane == 0) T[0] = stamp();\n  unsigned it = 0;\n"),
    (_LANDED, _LANDED + _STAMP.format(1)),
    (_CONVERTED, _STAMP.format(2) + _CONVERTED),
    (_MULTIPLIED, _MULTIPLIED + _STAMP.format(3)),
    (_QUANTIZED, _STAMP.format(4) + "    ++it;\n" + _QUANTIZED),
]
TIMELINE_READ = """
extern "C" int jpx_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));
}
extern "C" int jpx_stamps_clear() {
  void* a;
  cudaError_t err = cudaGetSymbolAddress(&a, g_stamp);
  return (int)(err != cudaSuccess ? err : cudaMemset(a, 0, sizeof(g_stamp)));
}
"""
ENTRY = {torch.uint8: "jpx_fdct_quant_u8", torch.uint16: "jpx_fdct_quant_u16",
         torch.int32: "jpx_fdct_quant_i32"}
# (cell, launch, launches a step, sample dtype, plane [rows, columns], hs, vs,
#  level shift, max sample): the stacked planes of one step.
CELLS = (
    ("recompress_16mp_b4", "luma", 1, torch.uint8, (4 * 4096, 4096), 1, 1, 128, 255),
    ("recompress_16mp_b4", "chroma", 2, torch.uint8, (4 * 4096, 4096), 2, 2, 128, 255),
    ("recompress_imagenet_b256", "luma", 1, torch.uint8, (256 * 384, 512), 1, 1, 128, 255),
    ("recompress_imagenet_b256", "chroma", 2, torch.uint8, (256 * 384, 512), 2, 2, 128, 255),
    ("recompress_ct12_b512", "slices", 1, torch.uint16, (512 * 512, 512), 1, 1, 2048, 4095),
)
TABLE = (
    [("Y", torch.uint8, 1, 1, 128, 255), ("chroma", torch.uint8, 2, 2, 128, 255),
     ("12-bit", torch.int32, 1, 1, 2048, 4095)]
    + [(f"{hs}x{vs}", dtype, hs, vs, 128, 255)
       for dtype in (torch.uint8, torch.int32)
       for hs, vs in ((3, 1), (1, 3), (3, 3), (4, 3), (4, 4))])


def variant_source(subs, text=None):
    text = SOURCE.read_text() if text is None else text
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"k2_probe: the source no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def build(sources, out_dir):
    """One library per named source, nvcc processes in parallel, as _build
    does; prints ptxas's lines for the K2 kernels."""
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
            raise SystemExit(f"k2_probe: nvcc failed for {name}:\n{log}")
        if name in ("old", "whole kernel"):
            kernel = None
            for ln in log.splitlines():
                if "Compiling entry function" in ln:
                    kernel = ln.split("'")[1] if "'" in ln else ln
                elif kernel and "fdct_quant" in kernel and ("registers" in ln or "spill" in ln):
                    print(f"build: {name}: {kernel}: {ln.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(str(so))
        for entry in ENTRY.values():
            getattr(lib, entry).argtypes = _build._ENTRY_POINTS[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def plane_of(dtype, shape, top, seed, device):
    """Seeded samples in [0, top] made on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = torch.randint(0, top + 1, shape, generator=g, device=device, dtype=torch.int32)
    if dtype == torch.uint16:  # no int32 -> uint16 cast on the card; the bits are the same
        return p.to(torch.int16).view(torch.uint16)
    return p.to(dtype)


def launcher(lib, plane, quant, split, hs, vs, level_shift):
    """A call of ``lib``'s K2 on ``plane`` and its output tensor."""
    h, w = plane.shape
    out = torch.empty((-(-h // (8 * vs)), -(-w // (8 * hs)), 64), dtype=torch.int16,
                      device=plane.device)
    entry = getattr(lib, ENTRY[plane.dtype])

    def call():
        err = entry(plane.data_ptr(), quant.data_ptr(), split.data_ptr(), out.data_ptr(), h, w,
                    out.shape[0], out.shape[1], hs, vs, level_shift,
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"k2_probe: launch failed with CUDA error {err}")
    return call, out


def compare(label, calls):
    """Run each call once; with two or more, exit unless the outputs are
    equal byte for byte."""
    outs = []
    for call, out in calls.values():
        call()
        torch.cuda.synchronize()
        outs.append(out.clone())
    if len(outs) > 1:
        same = all(torch.equal(outs[0], o) for o in outs[1:])
        print(f"check: {label}: outputs {'equal' if same else 'DIFFER'} byte for byte "
              f"({' / '.join(calls)})", flush=True)
        if not same:
            raise SystemExit("k2_probe: the libraries' outputs differ")


def timed(label, calls, plane, hs, vs, flush, extra=()):
    """Time every call (and ``extra`` (name, fn) pairs), flushed; print
    each with its share of K2's bound; return {name: ms}."""
    h, w = plane.shape
    n_blocks = -(-h // (8 * vs)) * -(-w // (8 * hs))
    bound_ms, _ = chip_smoke.k2_bound(n_blocks, plane.element_size(), h * w)
    names = [*calls, *(n for n, _ in extra)]
    fns = [call for call, _ in calls.values()] + [fn for _, fn in extra]
    got = dict(zip(names, chip_smoke.kernel_ms(*fns, flush=flush)))
    for name, ms in got.items():
        print(f"time: {label}, L2 flushed: {name} {ms * 1e3:.3f} us, {bound_ms / ms:.1%} of "
              f"K2's bound {bound_ms * 1e3:.3f} us (kernel time, mean of "
              f"{chip_smoke.TIMED_RUNS} in turns)", flush=True)
    return got


def timeline(lib, device, split, quant, flush):
    """Medians over the warps of the 16.8 MP luma's phases, in microseconds."""
    plane = plane_of(torch.uint8, (4 * 4096, 4096), 255, 2300, device)
    call, _ = launcher(lib, plane, quant, split, 1, 1, 128)
    host = np.zeros(4096 * _STAMPS, np.int64)
    for _ in range(3):  # the last run's stamps are read
        if lib.jpx_stamps_clear():
            raise SystemExit("k2_probe: could not clear the stamps")
        flush.zero_()
        torch.cuda.synchronize()
        call()
        torch.cuda.synchronize()
    if lib.jpx_stamps(host.ctypes.data):
        raise SystemExit("k2_probe: could not read the stamps")
    t = host.reshape(4096, _STAMPS)
    t = t[t[:, 0] > 0].astype(np.float64)
    rel = np.where(t > 0, (t - t[:, 0].min()) / 1e3, np.nan)
    print(f"timeline: {len(t)} warps, 16.8 MP luma, L2 flushed (globaltimer, 32 ns steps "
          f"or coarser)")
    prev = rel[:, 0]
    for it in range(9):
        landed, converted, multiplied, quantized = (rel[:, k + 4 * it] for k in (1, 2, 3, 4))
        if np.all(np.isnan(landed)):
            break
        print(f"timeline: tile {it}: {int((~np.isnan(landed)).sum())} warps; store of the last "
              f"half strip and wait for this one's bytes {np.nanmedian(landed - prev):.3f} us; "
              f"conversion {np.nanmedian(converted - landed):.3f} us; product (and the next "
              f"copies) {np.nanmedian(multiplied - converted):.3f} us; quantize "
              f"{np.nanmedian(quantized - multiplied):.3f} us; bytes landed at "
              f"{np.nanmedian(landed):.3f} us (median over warps)")
        prev = quantized


def main(argv=None):
    parser = argparse.ArgumentParser(description="K2 alone, timed on one GPU.")
    parser.add_argument("--old", type=pathlib.Path,
                        help="also build, check against and time this source of the kernel")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    device = torch.device("cuda")
    sources = {name: variant_source(subs) for name, subs in CUT.items()}
    sources["timeline"] = variant_source(TIMELINE) + TIMELINE_READ
    if args.old is not None:
        sources = {"old": args.old.read_text(), **sources}
    whole = ["old", "whole kernel"] if args.old is not None else ["whole kernel"]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, pathlib.Path(tmp))
        g = torch.Generator(device=device).manual_seed(2200)
        quant = torch.randint(1, 256, (64,), generator=g, device=device, dtype=torch.int32)
        split = kernels.fdct_split_operand(device)
        flush = torch.empty(chip_smoke.FLUSH_BYTES, dtype=torch.uint8, device=device)
        steps = {}
        for i, (cell, what, per_step, dtype, shape, hs, vs, ls, top) in enumerate(CELLS):
            plane = plane_of(dtype, shape, top, 2210 + i, device)
            label = f"{cell} {what} {shape[0]}x{shape[1]} {str(dtype)[6:]} {hs}x{vs}"
            compare(label, {n: launcher(libs[n], plane, quant, split, hs, vs, ls) for n in whole})
            calls = {n: launcher(libs[n], plane, quant, split, hs, vs, ls)
                     for n in [*whole[:-1], *CUT]}
            wide = torch.empty(shape, dtype=torch.int16, device=device)
            src = plane.view(torch.int16) if dtype == torch.uint16 else plane
            got = timed(label, calls, plane, hs, vs, flush,
                        extra=[("torch copy to int16", lambda: wide.copy_(src))])
            for name in whole:
                steps[(cell, name)] = steps.get((cell, name), 0.0) + per_step * got[name]
        for (cell, name), ms in steps.items():
            print(f"step: {cell}: {name}: K2 {ms:.6f} ms a step (L2 flushed)")
        for i, (label, dtype, hs, vs, ls, top) in enumerate(TABLE):
            plane = plane_of(dtype, (2048, 2048), top, 2240 + i, device)
            label = f"table {label} 2048x2048 {str(dtype)[6:]} {hs}x{vs}"
            calls = {n: launcher(libs[n], plane, quant, split, hs, vs, ls) for n in whole}
            compare(label, calls)
            timed(label, calls, plane, hs, vs, flush)
        timeline(libs["timeline"], device, split, quant, flush)


if __name__ == "__main__":
    main()
