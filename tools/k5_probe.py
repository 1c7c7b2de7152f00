"""Where K5's time goes on one NVIDIA GPU.

    python3 tools/k5_probe.py [--old PATH]

Builds variants of ``jpeglibrary_tpu_torch/csrc/symbol_hist.cu`` with one
part cut out by a text substitution (the counting, leaving the staged
loads; the AC walk, leaving loads and masks; the AC atomics, leaving the
walk and the symbols; the symbol arithmetic and its loads, leaving the walk
and the atomics; and 2 and 4 stages for 3), each into its own library under
a temporary directory, and times them with CUDA events
(``chip_smoke.device_ms``: median of 25 in turns, warm and with the L2
flushed) on ``full_step``'s requantised planes, read in place: 8 synthetic
2048x2048 q75 4:2:0 images made as ``chip_smoke.py`` makes them and run
through ``full_step`` on the card, the luma [8, 256, 256, 64] int16 at MCU
(2, 2) and the two chroma planes [8, 128, 128, 64] as one call; and on
all-zero planes of the luma's shape. Beside them a read yardstick (a
kernel that loads every 16 bytes once, coalesced, with no shared memory),
one torch copy of the same planes (each byte read and written once) and the
bytes bound (``chip_smoke.k5_bound``); and the consumer threads' clock64
cycles waiting for stages and counting, in one flushed call. Each whole
kernel's histograms are held to the plain version's (0 bins may differ).

With ``--old PATH``, also the kernel's previous design (a warp per 4
blocks of flat [B, N, 64] blocks in walk order, C entry ``(blocks,
n_valid, prev_dc, n_rows, n_cols, out, stream)``; for example ``git show
835f206:jpeglibrary_tpu_torch/csrc/symbol_hist.cu``) and its cuts, on the
same blocks put into walk order for it beforehand (untimed).

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

import chip_smoke  # noqa: E402  (device_ms, the flush size, the inputs, the bound)
from jpeglibrary_tpu_torch.ops import _build, encode_stage, kernels  # noqa: E402

SOURCE = ROOT / "jpeglibrary_tpu_torch" / "csrc" / "symbol_hist.cu"
CALL = "count_block<T>(stage + at * kBlockElems, prev, lane, dc_hist, ac_hist, zrl, eob);"
AC_ATOMIC = "    atomicAdd(&ac_hist[((run & 15) << 4) | coef_bits<T>(v)], 1);"
CUT = {  # variant: [(text in the source, its replacement)]
    "whole kernel": [],
    "staged loads only": [(CALL, "zrl += static_cast<int>(stage[at * kBlockElems]) + prev;")],
    "loads and masks": [
        ("  count_ac<T>(blk, mask, ac_hist, zrl);",
         "  zrl += static_cast<int>(mask ^ (mask >> 32));")],
    "no AC atomics": [(AC_ATOMIC, "    zrl += ((run & 15) << 4) | coef_bits<T>(v);")],
    "walk and atomics, no symbols": [(AC_ATOMIC, "    atomicAdd(&ac_hist[p], 1);")],
    "2 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "4 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
}
EXACT = {"whole kernel", "2 stages", "4 stages"}  # variants that keep the result
# The consumers' clock: cycles waiting for a stage and counting its block,
# summed over the consumer threads into a __device__ array that
# jpx_cycles reads back (clock64 per SM; a lane's count includes the time
# its warp spends on the other lanes' non-zeros).
CYCLES = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_cycles[4];\n"),
    ("    int eob = 0;\n",
     "    int eob = 0;\n    long long wait_cycles = 0, count_cycles = 0;\n"
     "    const long long loop_start = clock64();\n"),
    ("      mbar_wait(&full[s], (i / kStages) & 1);\n",
     "      const long long c0 = clock64();\n      mbar_wait(&full[s], (i / kStages) & 1);\n"
     "      wait_cycles += clock64() - c0;\n"),
    ("        " + CALL + "\n",
     "        const long long c1 = clock64();\n        " + CALL + "\n"
     "        count_cycles += clock64() - c1;\n"),
    ("    zrl = __reduce_add_sync(0xFFFFFFFFu, zrl);\n",
     "    atomicAdd(&g_cycles[0], static_cast<unsigned long long>(wait_cycles));\n"
     "    atomicAdd(&g_cycles[1], static_cast<unsigned long long>(count_cycles));\n"
     "    atomicAdd(&g_cycles[2], static_cast<unsigned long long>(clock64() - loop_start));\n"
     "    atomicAdd(&g_cycles[3], 1ull);\n"
     "    zrl = __reduce_add_sync(0xFFFFFFFFu, zrl);\n"),
]
CYCLES_READ = """
extern "C" int jpx_cycles(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_cycles, sizeof(g_cycles));
}
extern "C" int jpx_cycles_clear() {
  void* a;
  cudaError_t err = cudaGetSymbolAddress(&a, g_cycles);
  return (int)(err != cudaSuccess ? err : cudaMemset(a, 0, sizeof(g_cycles)));
}
"""
# A yardstick of the read alone: every 16 bytes of one or two ranges loaded
# once (4 loads in flight a thread, a grid of 8 CTAs of 256 threads an SM)
# and folded into one word, with no shared memory.
READ_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void __launch_bounds__(256) read_all(const int4* __restrict__ a, int64_t na,
                                                const int4* __restrict__ b, int64_t nb,
                                                int* out) {
  int acc = 0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
#pragma unroll 4
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < na + nb;
       i += step) {
    const int4 v = __ldg(i < na ? a + i : b + (i - na));
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x12345678) atomicAdd(out, 1);
}
extern "C" int jpx_read_all(const void* a, int64_t na, const void* b, int64_t nb, void* out,
                            void* stream) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  read_all<<<sms * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(a), na, static_cast<const int4*>(b), nb, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""
READ_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_void_p]
OLD_CALL = ("count_part(blocks, n_valid, prev_dc, t[k], lane, v[k], mask, dc_below, n_cols, rows,\n"
            "                   s_hist[warp], s_hist[warp] + 256);")
OLD_CUT = {
    "whole kernel": [],
    "loads only": [(OLD_CALL, 'asm volatile("" ::"r"(v[k][0] | v[k][1] | v[k][2] | v[k][3] | '
                              'v[k][4] | v[k][5] | v[k][6] | v[k][7]));')],
    "loads and masks": [(OLD_CALL, 'asm volatile("" ::"l"(mask), "r"(dc_below));')],
    "no atomics": [
        ("    atomicAdd(&dc_hist[bit_count(diff)], 1);",
         '    asm volatile("" ::"r"(bit_count(diff)));'),
        ("    atomicAdd(&ac_hist[((run & 15) << 4) | coef_bits<T>(v[j])], 1);",
         '    asm volatile("" ::"r"(((run & 15) << 4) | coef_bits<T>(v[j])));'),
        ("    if (run >= 16) atomicAdd(&ac_hist[0xF0], run >> 4);",
         '    if (run >= 16) asm volatile("" ::"r"(run >> 4));'),
        ("  if (part == 7 && v[7] == 0) atomicAdd(&ac_hist[0], 1);  // EOB",
         '  if (part == 7 && v[7] == 0) asm volatile("" ::"r"(part));  // EOB')],
    "loads and atomics only": [
        (OLD_CALL, "for (int j = 0; j < 8; ++j) {\n"
                   "          if (v[k][j] != 0) atomicAdd(&s_hist[warp][256 + (v[k][j] & 255)], 1);\n"
                   "        }")],
}
OLD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2


def variant_source(subs, text=None):
    text = SOURCE.read_text() if text is None else text
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"k5_probe: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build(sources, out_dir):
    """One library per variant, nvcc processes in parallel, as _build does."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{len(procs)}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"k5_probe: nvcc failed for {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"build: {name}: {'; '.join(regs)}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def call_new(lib, planes, mcu):
    """The kernel on planes in place; returns the [2, 256] histograms."""
    fn = lib.jpx_symbol_histograms_i16
    fn.argtypes = _build._ENTRY_POINTS["jpx_symbol_histograms_i16"]
    b, hb, wb = planes[0].shape[:3]
    out = torch.zeros((2, 256), dtype=torch.int32, device=planes[0].device)
    ptrs = [p.data_ptr() for p in planes] + [None] * (4 - len(planes))
    err = fn(*ptrs, len(planes), b, hb, wb, mcu[0], mcu[1], None, None, out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"k5_probe: launch failed with CUDA error {err}")
    return out


def call_read(lib, planes, out):
    """The read yardstick over the planes (one or two)."""
    fn = lib.jpx_read_all
    fn.argtypes = READ_ARGS
    a, b = planes[0], planes[-1] if len(planes) > 1 else None
    err = fn(a.data_ptr(), a.numel() * a.element_size() // 16,
             None if b is None else b.data_ptr(),
             0 if b is None else b.numel() * b.element_size() // 16, out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"k5_probe: launch failed with CUDA error {err}")


def call_old(lib, flat):
    """The previous design on [R, N, 64] blocks in walk order."""
    fn = lib.jpx_symbol_histograms_i16
    fn.argtypes = OLD_ARGS
    out = torch.zeros((2, 256), dtype=torch.int32, device=flat.device)
    err = fn(flat.data_ptr(), None, None, flat.shape[0], flat.shape[1], out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"k5_probe: launch failed with CUDA error {err}")
    return out


def step_planes(dev):
    """full_step's requantised planes of chip_smoke.py's 8 images."""
    from jpeglibrary_tpu_torch.parallel import sharding

    datas = [chip_smoke.encode_420(chip_smoke.synth_image(seed, chip_smoke.SIZE), 75)
             for seed in range(chip_smoke.N_IMAGES)]
    (y, cb, cr), (q_luma, q_chroma) = chip_smoke.step_inputs(datas)
    args = [torch.from_numpy(a).to(dev) for a in (y, cb, cr, q_luma, q_chroma)]
    _, requant, _ = sharding._step(*args, kernels.dequantize_idct_shift, kernels.fdct_quantize)
    return requant


def sources(old_text=None):
    """The variants' sources by name: this kernel's cuts ("new/..."), the
    read yardstick and, given the previous design's text, its cuts
    ("old/...")."""
    out = {f"new/{name}": variant_source(subs) for name, subs in CUT.items()}
    out["read yardstick"] = READ_SOURCE
    out["clock/whole kernel"] = variant_source(CYCLES) + CYCLES_READ

    if old_text is not None:
        out.update({f"old/{name}": variant_source(subs, old_text)
                    for name, subs in OLD_CUT.items()})
    return out


def cycles(lib, planes, mcu, flush):
    """The consumers' mean cycles (waiting for stages, counting, in all)
    in one L2-flushed call of a clock variant."""
    host = np.zeros(4, np.uint64)
    lib.jpx_cycles.argtypes = [ctypes.c_void_p]
    lib.jpx_cycles_clear()
    flush.zero_()
    call_new(lib, planes, mcu)
    torch.cuda.synchronize()
    if lib.jpx_cycles(host.ctypes.data):
        raise SystemExit("k5_probe: could not read the cycles")
    wait, count, total, threads = (float(x) for x in host)
    return wait / threads, count / threads, total / threads


def time_parts(libs, label, planes, mcu, flush, modes=("warm", "L2 flushed")):
    """Each variant of ``libs`` on ``planes`` (walked at ``mcu``), the read
    yardstick and a torch copy of the planes, in CUDA events; each whole
    kernel first held to the plain version (0 bins may differ). Prints a
    line a variant and mode; returns {(mode, name): ms}."""
    dev = planes[0].device
    flat = encode_stage.mcu_walk(planes, mcu).contiguous()
    want = torch.stack(encode_stage.symbol_histograms_plain(flat))
    names, fns = [], []
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    for name, lib in libs.items():
        if name.startswith("clock/"):
            wait, count, total = cycles(lib, planes, mcu, flush)
            print(f"cycles: {label}, L2 flushed: {name[6:]}: a consumer thread waits "
                  f"{wait:.0f} cycles for its stages and counts for {count:.0f}, of {total:.0f} "
                  f"in its loop (clock64, mean over the consumer threads)")
            continue
        if name == "read yardstick":
            names.append("read yardstick (each byte loaded once, no shared memory)")
            fns.append(lambda lib=lib: call_read(lib, planes, sink))
            continue
        if name.startswith("new/"):
            fn = (lambda lib=lib: call_new(lib, planes, mcu))
        else:
            fn = (lambda lib=lib: call_old(lib, flat))
        if name.split("/")[1] in EXACT:
            n_diff = int((fn() != want).sum())
            print(f"check: {label}: {name}: {n_diff}/512 bins differ from the plain version")
            if n_diff:
                raise SystemExit("k5_probe: a whole kernel differs from its plain version")
        names.append(name)
        fns.append(fn)
    copies = [torch.empty_like(p) for p in planes]
    names.append("torch copy of the same planes")
    fns.append(lambda: [c.copy_(p) for c, p in zip(copies, planes)])
    b_ms, b_by = chip_smoke.k5_bound(sum(p.numel() for p in planes) // 64, 2)
    out = {}
    for what in modes:
        kwargs = {"flush": flush} if what == "L2 flushed" else {}
        for name, ms in zip(names, chip_smoke.device_ms(*fns, **kwargs)):
            out[(what, name)] = ms
            print(f"parts: {label}, {what}: {name} {ms * 1e3:.3f} us ({b_ms / ms:.1%} of the "
                  f"{b_by} bound {b_ms * 1e3:.3f} us; CUDA events, median of "
                  f"{chip_smoke.TIMED_RUNS} in turns)", flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="K5's parts, timed on one GPU.")
    parser.add_argument("--old", type=pathlib.Path,
                        help="also time this source of the kernel's previous design")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_probe: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    requant_y, requant_cb, requant_cr = step_planes(dev)
    inputs = [("luma [8, 256, 256, 64] int16, MCU (2, 2)", (requant_y,), (2, 2)),
              ("chroma 2 x [8, 128, 128, 64] int16", (requant_cb, requant_cr), (1, 1)),
              ("all-zero luma [8, 256, 256, 64] int16", (torch.zeros_like(requant_y),), (2, 2))]
    for label, planes, _ in inputs[:2]:
        n_blocks = sum(p.numel() for p in planes) // 64
        nz = sum(int((p[..., 1:] != 0).sum()) for p in planes)
        print(f"input: {label}: {nz / n_blocks:.3f} non-zero AC coefficients a block")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources(None if args.old is None else args.old.read_text()),
                     pathlib.Path(tmp))
        flush = torch.empty(chip_smoke.FLUSH_BYTES, dtype=torch.uint8, device=dev)
        for label, planes, mcu in inputs:
            time_parts(libs, label, planes, mcu, flush)


if __name__ == "__main__":
    main()
