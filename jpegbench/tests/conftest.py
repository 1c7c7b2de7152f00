"""Helpers of the harness's CPU tests: a checkout in a temporary
directory that holds a copy of the harness and ``BENCHMARK.json`` plus a
tiny cell, whose files are new files of the copy (no file of the harness
is edited)."""

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = "tiny_b3"
TINY_LIMITS = {"rgb_diff_share": 4e-4, "requant_diff_share": 1e-4, "luma_hist_bins_off": 0,
               "chroma_hist_l1_share": 1e-4}


def make_checkout(tmp: pathlib.Path, content: str = "histology", width: int = 100,
                  height: int = 60) -> pathlib.Path:
    """A checkout with the benchmark's files and a cell ``tiny_b3``: its
    configuration, traffic mix and limits as new files, every per-layer
    metric listing it."""
    shutil.copytree(ROOT / "jpegbench", tmp / "jpegbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "test", "file": "jpegbench/configs/tiny.json",
                            "reduced": [], "why": "a CPU test's size"})
    (tmp / "jpegbench/configs/tiny.json").write_text(json.dumps(
        {"width": width, "height": height, "quality": 75, "content": content}))
    spec["workloads"].append({"name": TINY, "config": "tiny", "traffic": "recompress_b3",
                              "chips": 1, "why": "a CPU test's size"})
    (tmp / "jpegbench/traffic/recompress_b3.json").write_text(json.dumps(
        {"entry": "recompress", "batch": 3, "pool": 2, "in_flight": 2}))
    (tmp / f"jpegbench/limits/{TINY}.json").write_text(json.dumps(TINY_LIMITS))
    for m in spec["per_layer"]:
        m["workloads"].append(TINY)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def checkout(tmp_path):
    return make_checkout(tmp_path)
