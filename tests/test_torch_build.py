"""PyTorch port, its builds: the native scanner (g++) and the CUDA kernel
library (nvcc) are compiled once per machine. Callers that arrive while
another compiles wait on the build's lock file and then take its
library, so parallel test workers do not each compile their own copy."""

import pathlib
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import pytest

pytest.importorskip("torch")

from jpeglibrary_tpu_torch.host.native import build as native_build
from jpeglibrary_tpu_torch.ops import _build

CALLERS = 4


def _race(fn):
    with ThreadPoolExecutor(CALLERS) as pool:
        return list(pool.map(lambda _: fn(), range(CALLERS)))


def test_scanner_compiles_once_for_concurrent_callers(tmp_path, monkeypatch):
    src = tmp_path / "scanner.cpp"
    src.write_text('extern "C" int jpx_probe() { return 7; }\n')
    monkeypatch.setattr(native_build, "_SRC", src)
    monkeypatch.setenv("JPX_NATIVE_BUILD_DIR", str(tmp_path / "_build"))
    compiles = []
    lock = threading.Lock()

    def slow_run(cmd, **kwargs):
        with lock:
            compiles.append(cmd)
        time.sleep(0.3)  # the others arrive while this one compiles
        out = pathlib.Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"library")

    monkeypatch.setattr(native_build, "subprocess", types.SimpleNamespace(run=slow_run))
    paths = _race(native_build.build_library)
    assert len(compiles) == 1
    assert len(set(paths)) == 1 and paths[0].read_bytes() == b"library"
    assert not list(paths[0].parent.glob("*.tmp"))


def test_kernel_library_compiles_once_for_concurrent_callers(tmp_path, monkeypatch):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "probe.cu").write_text("// probe\n")
    monkeypatch.setattr(_build, "_PKG", tmp_path)
    monkeypatch.setattr(_build, "_CSRC", tmp_path / "csrc")
    compiles = []
    lock = threading.Lock()

    def slow_compile(sources, so_path):
        with lock:
            compiles.append([s.name for s in sources])
        time.sleep(0.3)
        so_path.write_bytes(b"library")

    monkeypatch.setattr(_build, "_compile", slow_compile)
    paths = _race(_build.build_library)
    assert compiles == [["probe.cu"]]
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path / "_build"
