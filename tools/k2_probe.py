"""Where K2's time goes on one NVIDIA GPU.

    python3 tools/k2_probe.py

Builds variants of ``jpeglibrary_tpu_torch/csrc/fdct_quant.cu`` with one
part cut out by a text substitution (the product's MMAs; the IEEE division,
replaced by a multiply; the whole product and epilogue; the conversion as
well), each into its own library under a temporary directory, and times
them on the Y plane (2048x2048 uint8, 1x1) and a chroma plane (2048x2048
uint8, 2x2) beside one PyTorch copy with the Y plane's traffic (uint8 ->
int16: 4.2 MB in, 8.4 MB out): kernel time from ``torch.profiler``, warm
and with the L2 flushed (``chip_smoke.kernel_ms``). The variants compute
wrong coefficients; they only time the parts. Then a per-CTA timeline of
the whole kernel on the flushed Y plane: ``%globaltimer`` stamps by thread 0
of each CTA at the start, after each strip's first barrier (its bytes have
landed), after its conversion barrier and after its product, summarised
as medians over the CTAs. Prints the card's name and power limit first.
Exits non-zero without a CUDA device. Writes nothing but temporary files.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (kernel_ms, the flush size)
from jpeglibrary_tpu_torch.ops import _build, kernels  # noqa: E402

SOURCE = ROOT / "jpeglibrary_tpu_torch" / "csrc" / "fdct_quant.cu"
CUT = {  # variant: [(text in the source, its replacement)]
    "whole kernel": [],
    "no MMAs": [("          mma_bf16(acc[m][j], a[m][kk]",
                 "          if (0) mma_bf16(acc[m][j], a[m][kk]")],
    "multiply for divide": [
        ("__fdiv_rn(acc[m][j][2 * half], q[j][0])", "(acc[m][j][2 * half] * q[j][0])"),
        ("__fdiv_rn(acc[m][j][2 * half + 1], q[j][1])", "(acc[m][j][2 * half + 1] * q[j][1])")],
    "no product or epilogue": [
        ("    multiply_strip(a_hi", "    if (level_shift == 12345) multiply_strip(a_hi")],
    "copies and stores only": [
        ("    multiply_strip(a_hi", "    if (level_shift == 12345) multiply_strip(a_hi"),
        ("    convert_strip<SampleT, HS, VS>(stages",
         "    if (level_shift == 12345) convert_strip<SampleT, HS, VS>(stages")],
}
# The timeline: stamps into a __device__ array, read back by a C function.
TIMELINE = [
    ("namespace {\n", "namespace {\n__device__ long long g_stamp[4096 * 40];\n"
     "__device__ __forceinline__ long long stamp() {\n  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"),
    ("  unsigned strip = blockIdx.x;\n", "  unsigned strip = blockIdx.x;\n"
     "  long long* T = g_stamp + blockIdx.x * 40;\n  if (tid == 0) T[0] = stamp();\n"),
    ("    __syncthreads();  // every thread's copies; the last strip's tiles and stage are free\n",
     "    __syncthreads();  // every thread's copies; the last strip's tiles and stage are free\n"
     "    if (tid == 0 && it < 9) T[1 + it * 4] = stamp();\n"),
    ("    multiply_strip(a_hi, a_lo, out_s, bf, q, two_a, warp, lane);\n",
     "    if (tid == 0 && it < 9) T[2 + it * 4] = stamp();\n"
     "    multiply_strip(a_hi, a_lo, out_s, bf, q, two_a, warp, lane);\n"),
    ("    done = strip;\n  }\n", "    if (tid == 0 && it < 9) T[3 + it * 4] = stamp();\n"
     "    done = strip;\n  }\n"),
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
ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def variant_source(subs):
    text = SOURCE.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"k2_probe: the source no longer holds {old!r}")
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
            raise SystemExit(f"k2_probe: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        libs[name].jpx_fdct_quant_u8.argtypes = ARGS
    return libs


def launch(lib, plane, quant, split, out, hs, vs):
    h, w = plane.shape
    err = lib.jpx_fdct_quant_u8(plane.data_ptr(), quant.data_ptr(), split.data_ptr(),
                                out.data_ptr(), h, w, out.shape[0], out.shape[1], hs, vs, 128,
                                torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"k2_probe: launch failed with CUDA error {err}")


def timeline(lib, plane, quant, split, flush):
    """Medians over the CTAs of the Y plane's phases, in microseconds."""
    out = torch.empty((256, 256, 64), dtype=torch.int16, device=plane.device)
    host = np.zeros(4096 * 40, np.int64)
    for _ in range(3):  # the last run's stamps are read
        if lib.jpx_stamps_clear():
            raise SystemExit("k2_probe: could not clear the stamps")
        flush.zero_()
        torch.cuda.synchronize()
        launch(lib, plane, quant, split, out, 1, 1)
        torch.cuda.synchronize()
    if lib.jpx_stamps(host.ctypes.data):
        raise SystemExit("k2_probe: could not read the stamps")
    t = host.reshape(4096, 40)
    t = t[t[:, 0] > 0].astype(np.float64)
    rel = np.where(t > 0, (t - t[:, 0].min()) / 1e3, np.nan)
    print(f"timeline: {len(t)} CTAs, Y plane, L2 flushed (globaltimer, 256 ns steps on the H100)")
    prev = rel[:, 0]
    for it in range(9):
        landed, converted, multiplied = (rel[:, k + 4 * it] for k in (1, 2, 3))
        if np.all(np.isnan(landed)):
            break
        print(f"timeline: strip {it}: {int((~np.isnan(landed)).sum())} CTAs; wait for its bytes "
              f"{np.nanmedian(landed - prev):.3f} us; store of the last strip, next copies and "
              f"conversion {np.nanmedian(converted - landed):.3f} us; product and quantize "
              f"{np.nanmedian(multiplied - converted):.3f} us; bytes landed at "
              f"{np.nanmedian(landed):.3f} us (median over CTAs)")
        prev = multiplied


def main():
    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device; nothing was run", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        sources = {name: variant_source(subs) for name, subs in CUT.items()}
        sources["timeline"] = variant_source(TIMELINE) + TIMELINE_READ
        libs = build(sources, pathlib.Path(tmp))
        rng = np.random.default_rng(1)
        plane = torch.from_numpy(rng.integers(0, 256, (2048, 2048)).astype(np.uint8)).to(dev)
        quant = torch.from_numpy(rng.integers(1, 256, 64).astype(np.int32)).to(dev)
        split = kernels.fdct_split_operand(dev)
        flush = torch.empty(chip_smoke.FLUSH_BYTES, dtype=torch.uint8, device=dev)
        wide = torch.empty((2048, 2048), dtype=torch.int16, device=dev)
        for label, hs, vs in (("Y 2048x2048 uint8 1x1", 1, 1), ("chroma 2048x2048 uint8 2x2", 2, 2)):
            out = torch.empty((2048 // (8 * vs), 2048 // (8 * hs), 64), dtype=torch.int16,
                              device=dev)
            names = list(CUT)
            fns = [lambda lib=libs[n]: launch(lib, plane, quant, split, out, hs, vs) for n in names]
            names.append("torch copy uint8 -> int16 of the 2048x2048 plane")
            fns.append(lambda: wide.copy_(plane))
            for what, kwargs in (("warm", {}), ("L2 flushed", {"flush": flush})):
                for name, ms in zip(names, chip_smoke.kernel_ms(*fns, **kwargs)):
                    print(f"parts: {label}, {what}: {name} {ms * 1e3:.3f} us (kernel time, "
                          f"mean of {chip_smoke.TIMED_RUNS})")
        timeline(libs["timeline"], plane, quant, split, flush)


if __name__ == "__main__":
    main()
