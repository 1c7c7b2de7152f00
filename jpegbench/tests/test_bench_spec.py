"""``BENCHMARK.json`` against the benchmark's contract, the imports of the
harness, and the work counts of the per-layer metrics at both cells'
shapes, worked out by hand."""

import ast
import json
import re
import subprocess
import sys

import pytest

from conftest import ROOT
from jpegbench.core import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
FORBIDDEN = {"jax", "jaxlib", "flax", "jpeglibrary_tpu"}
SOURCES = sorted((ROOT / "jpegbench").rglob("*.py"))


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "jpegbench/run.py"]
    assert BENCH["paths"] == ["jpegbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert cells <= 24 and sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("jpegbench/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        allowed = ({"name", "unit", "better", "bound", "source"} if "bound" in m else
                   {"name", "unit", "better", "source", "layer", "moves"}) | {"workloads"}
        assert set(m) <= allowed and m["better"] in ("lower", "higher")
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        names.append(m["name"])
    for text in [c["source"] for c in BENCH["configs"]] + [
            x["why"] for x in BENCH["configs"] + BENCH["workloads"]] + [
            m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert all(NAME.fullmatch(n) for n in names), names
    assert len(set(names)) == len(names)


def test_metrics_and_cells_hang_together():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert (ROOT / "jpegbench/metrics" / f"{m['name']}.py").is_file()
    for w in BENCH["workloads"]:
        loaded = spec.load(w["name"])
        assert (ROOT / "jpegbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "jpegbench/entries" / f"{loaded.traffic['entry']}.py").is_file()
        assert loaded.per_layer and len(loaded.end_to_end) >= 2


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "jpegbench/reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & (FORBIDDEN | {"jpeglibrary_tpu_torch"}), path
    code = ("import sys; sys.path.insert(0, %r); import jpegbench.reference.recompress; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    loaded = json.loads(subprocess.check_output([sys.executable, "-c", code], text=True)
                        .replace("'", '"'))
    assert not set(loaded) & (FORBIDDEN | {"jpeglibrary_tpu_torch"})


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process, then its modules' top-level names."""
    code = f"""
import sys, time, pathlib, tempfile
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(ROOT / 'jpegbench/tests')!r})
import torch
from conftest import TINY, make_checkout
from jpegbench.core import harness
root = make_checkout(pathlib.Path(tempfile.mkdtemp()))
record = harness.run(TINY, 7, 0.2, False, time.perf_counter(), root=root, device=torch.device("cpu"))
assert record["correct"], record
print(" ".join(sorted({{m.split(".")[0] for m, v in sys.modules.items() if v is not None}})))
"""
    out = subprocess.check_output([sys.executable, "-c", code], text=True)
    loaded = set(out.split())
    assert "jpeglibrary_tpu_torch" in loaded and not loaded & FORBIDDEN


# --- Work counts at the cells' shapes, by hand ------------------------------

HET = {"batch": 4, "width": 4096, "height": 4096, "hb": 512, "wb": 512}
NET = {"batch": 256, "width": 500, "height": 375, "hb": 48, "wb": 64}
MB = 3.35e12  # bytes a second


def _reader(name):
    import importlib.util

    s = importlib.util.spec_from_file_location(name, ROOT / "jpegbench/metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(s)
    s.loader.exec_module(module)
    return module


@pytest.mark.parametrize("shape,k1,k2,k5,step", [
    # K1: 1,048,576 luma and 2 x 262,144 chroma blocks, each 128 B in and
    # 256 B out, and a 256 B table a launch: 603,980,544 B.
    # K2: 3 planes of 67,108,864 B in, 256 B tables, 201,326,592 B out.
    # K5: 201,326,592 B of blocks in, 2 x 2,048 B out.
    # Step: 67,108,864 pixels x 8 B = 536,870,912 B.
    (HET, 603_980_544, 402_653_952, 201_330_688, 536_870_912),
    # 786,432 luma and 2 x 196,608 chroma blocks; 3 planes of 50,331,648 B.
    (NET, 452_985_600, 301_990_656, 150_999_040, 402_653_184),
], ids=["recompress_16mp_b4", "recompress_imagenet_b256"])
def test_work_counts(shape, k1, k2, k5, step):
    assert _reader("k1_roofline.recompress").step_bound_s(shape) == pytest.approx(k1 / MB)
    assert _reader("k2_roofline.recompress").step_bound_s(shape) == pytest.approx(k2 / MB)
    assert _reader("k5_roofline.recompress").step_bound_s(shape) == pytest.approx(k5 / MB)
    assert _reader("step_roofline.recompress").step_bound_s(shape) == pytest.approx(step / MB)


def test_cell_shapes():
    from jpegbench.entries.recompress import shape

    for name, want in (("recompress_16mp_b4", HET), ("recompress_imagenet_b256", NET)):
        w = spec.load(name)
        assert shape(w.config, w.traffic) == want
