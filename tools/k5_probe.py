"""Where K5's time goes on one NVIDIA GPU.

    python3 tools/k5_probe.py [--old PATH] [--seed N]

Builds variants of ``jpeglibrary_tpu_torch/csrc/symbol_hist.cu`` with one
part cut out by a text substitution (the counting, leaving the staged
loads; the AC walk, leaving loads and masks; the AC atomics, leaving the
walk and the symbols; the symbol arithmetic, leaving the walk and the
atomics; the values gathered from addresses rotated by the lane, so that no
two lanes of a warp meet on one shared-memory bank, with and without the
AC atomics; and 2 and 4 stages for 3), each into its own library under a
temporary directory, and times them with CUDA events
(``chip_smoke.device_ms``: median of 25 in turns, warm and with the L2
flushed) on requantised planes read in place:

- ``full_step``'s planes of 8 synthetic 2048x2048 q75 4:2:0 images made as
  ``chip_smoke.py`` makes them, the luma [8, 256, 256, 64] int16 at MCU
  (2, 2) and the two chroma planes as one call, and all-zero planes of the
  luma's shape;
- each benchmark cell's: its first pool batch made from ``--seed`` by the
  cell's own entry (``jpegbench/entries``) and run through the cell's step
  (``full_step`` or ``gray_step``) on the card, each plane K5 counts there
  at its MCU walk: the 16.8 MP and ImageNet luma at (2, 2) and chroma at
  (1, 1), the CT series at (1, 1), the 4:2:2 luma at (2, 1) and chroma at
  (1, 1).

Beside them a read yardstick (a kernel that loads every 16 bytes once,
coalesced, with no shared memory), one torch copy of the same planes (each
byte read and written once) and the bytes bound (``chip_smoke.k5_bound``);
and, in one flushed call, the consumer threads' clock64 cycles waiting for
their stages and counting them (from a stage's arrival to the warp's
release of it), with the count's cycles per AC symbol: summed over the
consumer threads, over the planes' non-zero AC coefficients and the
consumer threads an SM holds, the SM's cycles a symbol when its resident
warps count at once. Each exact variant's histograms are held to the plain
version's (0 bins may differ); the cuts that change the result are timed
only.

With ``--old PATH``, also another source of the kernel with the same C
entry points (for example ``git show <commit>:jpeglibrary_tpu_torch/csrc/
symbol_hist.cu``), whole and under the same clock, held to the plain
version first.

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
CALL = "count_block<T>(stage + at * kBlockElems, mask, diff, dc_hist, ac_hist, zrl, eob);"
MASK = "      if (valid) mask = nonzero_mask<T>(stage + at * kBlockElems, lane, dc);\n"
AC_ATOMIC = "    atomicAdd(&ac_hist[((run & 15) << 4) | coef_bits<T>(v)], 1);"
NO_AC_ATOMIC = "    zrl += ((run & 15) << 4) | coef_bits<T>(v);"
# The values read from addresses rotated by 2 positions a lane: a lane's
# 4-byte word moves one bank a lane, so lanes that stand at one position of
# their blocks meet 32 different banks (timing only: wrong values).
ROTATED = [("  int32_t v = blk[p & 63];\n", "  int32_t v = blk[(p + 2 * (threadIdx.x & 31)) & 63];\n"),
           ("    const int32_t v_next = blk[next & 63];\n",
            "    const int32_t v_next = blk[(next + 2 * (threadIdx.x & 31)) & 63];\n")]
CUT = {  # variant: [(text in the source, its replacement)]
    "whole kernel": [],
    "staged loads only": [(MASK, "      if (valid) dc = stage[at * kBlockElems + lane % 8];\n"),
                          (CALL, "zrl += diff;")],
    "loads and masks": [(CALL, "zrl += static_cast<int>(mask ^ (mask >> 32)) + diff;")],
    "no AC atomics": [(AC_ATOMIC, NO_AC_ATOMIC)],
    "walk and atomics, no symbols": [(AC_ATOMIC, "    atomicAdd(&ac_hist[p], 1);")],
    "conflict-free gather": ROTATED,
    "conflict-free gather, no AC atomics": ROTATED + [(AC_ATOMIC, NO_AC_ATOMIC)],
    "2 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "4 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
}
EXACT = {"whole kernel", "2 stages", "4 stages"}  # variants that keep the result
# The consumers' clock: cycles waiting for a stage, and from its arrival to
# the warp's release of it, summed over the consumer threads into a
# __device__ array that jpx_cycles reads back (clock64 per SM; a lane's
# count includes the time its warp spends on the other lanes' blocks).
CYCLES = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_cycles[4];\n"),
    ("    int eob = 0;\n",
     "    int eob = 0;\n    long long wait_cycles = 0, count_cycles = 0;\n"
     "    const long long loop_start = clock64();\n"),
    ("      mbar_wait(&full[s], (i / kStages) & 1);\n",
     "      const long long c0 = clock64();\n      mbar_wait(&full[s], (i / kStages) & 1);\n"
     "      const long long c1 = clock64();\n      wait_cycles += c1 - c0;\n"),
    ("      __syncwarp();\n      if (lane == 0) mbar_arrive(&empty[s]);\n",
     "      __syncwarp();\n      count_cycles += clock64() - c1;\n"
     "      if (lane == 0) mbar_arrive(&empty[s]);\n"),
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
extern "C" int jpx_consumers_per_sm(int* n) {
  int ctas = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, symbol_hist_kernel<int16_t>, kThreads, smem_bytes<int16_t>());
  *n = ctas * kTileBlocks;
  return (int)err;
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
CELLS = ("recompress_16mp_b4", "recompress_imagenet_b256", "recompress_ct12_b512",
         "recompress_24mp_422_b4")


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


def step_planes(dev):
    """full_step's requantised planes of chip_smoke.py's 8 images."""
    from jpeglibrary_tpu_torch.parallel import sharding

    datas = [chip_smoke.encode_420(chip_smoke.synth_image(seed, chip_smoke.SIZE), 75)
             for seed in range(chip_smoke.N_IMAGES)]
    (y, cb, cr), (q_luma, q_chroma) = chip_smoke.step_inputs(datas)
    args = [torch.from_numpy(a).to(dev) for a in (y, cb, cr, q_luma, q_chroma)]
    _, requant, _ = sharding._step(*args, kernels.dequantize_idct_shift, kernels.fdct_quantize)
    return requant


def cell_planes(name, seed, dev):
    """The planes K5 counts in one step of the benchmark cell ``name`` on its
    first pool batch from ``seed``: a list of (planes, mcu)."""
    from jpegbench.core import spec
    from jpeglibrary_tpu_torch.parallel import sharding

    workload = spec.load(name)
    run = workload.entry().Run(workload, seed, dev, None)
    batch = run._batch(torch.Generator(device=dev).manual_seed(seed))
    if workload.traffic["entry"] == "recompress_gray12":
        _, requant, _ = sharding.gray_step(batch, run.q, precision=run.bits, device=dev)
        return [((requant,), (1, 1))]
    _, (y, cb, cr), _ = sharding._step(*sharding._step_inputs(*batch, run.qy, run.qc, dev))
    return [((y,), (y.shape[2] // cb.shape[2], y.shape[1] // cb.shape[1])), ((cb, cr), (1, 1))]


def sources(old_text=None):
    """The variants' sources by name: this kernel's cuts ("new/..."), the
    read yardstick, the clock and, given another source of the kernel, that
    source whole and under the clock ("old/...")."""
    out = {f"new/{name}": variant_source(subs) for name, subs in CUT.items()}
    out["read yardstick"] = READ_SOURCE
    out["clock/whole kernel"] = variant_source(CYCLES) + CYCLES_READ
    if old_text is not None:
        out["old/whole kernel"] = old_text
        out["clock/old whole kernel"] = variant_source(CYCLES, old_text) + CYCLES_READ
    return out


def cycles(lib, planes, mcu, flush):
    """The consumers' mean cycles (waiting for stages, counting, in all)
    in one L2-flushed call of a clock variant, their sum over the counting,
    and the CTAs an SM holds."""
    host = np.zeros(4, np.uint64)
    lib.jpx_cycles.argtypes = [ctypes.c_void_p]
    lib.jpx_cycles_clear()
    flush.zero_()
    call_new(lib, planes, mcu)
    torch.cuda.synchronize()
    if lib.jpx_cycles(host.ctypes.data):
        raise SystemExit("k5_probe: could not read the cycles")
    consumers = ctypes.c_int(0)
    if lib.jpx_consumers_per_sm(ctypes.byref(consumers)):
        raise SystemExit("k5_probe: could not read the consumer threads an SM holds")
    wait, count, total, threads = (float(x) for x in host)
    return wait / threads, count / threads, total / threads, count, consumers.value


def time_parts(libs, label, planes, mcu, flush, modes=("warm", "L2 flushed")):
    """Each variant of ``libs`` on ``planes`` (walked at ``mcu``), the read
    yardstick and a torch copy of the planes, in CUDA events; each exact
    variant first held to the plain version (0 bins may differ). Prints a
    line a variant and mode; returns {(mode, name): ms}."""
    dev = planes[0].device
    flat = encode_stage.mcu_walk(planes, mcu).contiguous()
    want = torch.stack(encode_stage.symbol_histograms_plain(flat))
    n_blocks = sum(p.numel() for p in planes) // 64
    symbols = sum(int((p[..., 1:] != 0).sum()) for p in planes)
    print(f"input: {label}: {n_blocks} blocks, {symbols / n_blocks:.3f} non-zero AC "
          "coefficients a block")
    names, fns = [], []
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    for name, lib in libs.items():
        if name.startswith("clock/"):
            wait, count, total, summed, consumers = cycles(lib, planes, mcu, flush)
            per_symbol = summed / max(symbols, 1)
            print(f"cycles: {label}, L2 flushed: {name[6:]}: a consumer thread waits "
                  f"{wait:.0f} cycles for its stages and counts for {count:.0f}, of {total:.0f} "
                  f"in its loop (clock64, mean over the consumer threads); the count's cycles "
                  f"per AC symbol {per_symbol:.1f} a thread, "
                  f"{per_symbol / consumers:.3f} an SM ({consumers} consumer threads an SM)")
            continue
        if name == "read yardstick":
            names.append("read yardstick (each byte loaded once, no shared memory)")
            fns.append(lambda lib=lib: call_read(lib, planes, sink))
            continue
        fn = (lambda lib=lib: call_new(lib, planes, mcu))
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
    b_ms, b_by = chip_smoke.k5_bound(n_blocks, 2)
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
                        help="also time this source of the kernel (the same C entry points)")
    parser.add_argument("--seed", type=int, default=25,
                        help="the seed of the cells' pool batches")
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
    for cell in CELLS:
        for planes, mcu in cell_planes(cell, args.seed, dev):
            shape = list(planes[0].shape)
            inputs.append((f"{cell}: {len(planes)} x {shape} int16, MCU {mcu}", planes, mcu))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources(None if args.old is None else args.old.read_text()),
                     pathlib.Path(tmp))
        flush = torch.empty(chip_smoke.FLUSH_BYTES, dtype=torch.uint8, device=dev)
        for label, planes, mcu in inputs:
            time_parts(libs, label, planes, mcu, flush)


if __name__ == "__main__":
    main()
