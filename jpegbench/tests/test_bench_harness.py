"""The harness on the CPU: it finds what a later change adds as new files,
drives a whole run but for the look for a card, refuses to measure
without one, and judges a broken step as not correct."""

import json
import time

import pytest
import torch

from conftest import TINY, make_checkout
from jpegbench import run as run_script
from jpegbench.core import harness, spec

CPU = torch.device("cpu")
SEED = 2**31 + 12345  # larger than 32 signed bits hold, as the driver's seeds are


def _run(root, trace=False, seconds=0.3, seed=SEED):
    return harness.run(TINY, seed, seconds, trace, time.perf_counter(), root=root, device=CPU)


def test_finds_added_config_traffic_and_metric(tmp_path):
    root = make_checkout(tmp_path, width=48, height=32)
    (root / "jpegbench/metrics/steps_seen.test.py").write_text(
        "def read(ctx):\n    return float(ctx.window.steps)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_seen.test", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "recompress_mp_s", "workloads": [TINY]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    w = spec.load(TINY, root)
    assert (w.config["width"], w.traffic["batch"]) == (48, 3)
    assert "steps_seen.test" in [m["name"] for m in w.per_layer]
    record = _run(root, trace=True)
    assert record["metrics"]["steps_seen.test"]["value"] == record["attempted"] > 0
    assert record["correct"], record["check"]


def test_plain_run_reports_end_to_end_metrics(checkout):
    record = _run(checkout)
    assert record["correct"] and record["failed"] == 0
    assert set(record["metrics"]) == {"recompress_mp_s", "setup_s", "peak_mem_gib"}
    assert record["metrics"]["recompress_mp_s"]["value"] > 0
    assert list(record)[-1] == "check"
    assert set(record["check"]) == set(json.loads(
        (checkout / f"jpegbench/limits/{TINY}.json").read_text()))


def test_traced_run_reports_per_layer_metrics(checkout):
    record = _run(checkout, trace=True)
    # The CPU runs no kernel: only what the host reads is there.
    assert set(record["metrics"]) == {"dispatch_ms.recompress", "device_idle_pct.recompress",
                                      "step_roofline.recompress"}
    assert record["device"]["window_s"] > 0 and "breakdown" in record
    assert list(record)[-1] == "check"


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_script.main(["--workload", "recompress_16mp_b4", "--seed", "1", "--seconds", "1",
                            "--trace", "0"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_refuses_with_too_few_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(harness.RunError, match="asks for 1"):
        harness.card(1)


def test_refuses_after_a_forbidden_import(checkout, monkeypatch):
    import types

    monkeypatch.setitem(__import__("sys").modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.RunError, match="jax"):
        _run(checkout)


def test_emit_ends_both_streams_with_the_check(checkout, capsys):
    harness.emit(_run(checkout))
    out = capsys.readouterr()
    record = json.loads(out.out.strip().splitlines()[-1])
    lines = out.err.strip().splitlines()[-len(record["check"]):]
    assert [ln.split()[1] for ln in lines] == list(record["check"])
    assert all(" limit " in ln for ln in lines)


# --- A broken step underneath must come out as not correct ------------------

def _stale(full_step):
    """A step that returns its state unchanged: the first call's outputs
    for every later call."""
    first = []

    def step(*args, **kwargs):
        if not first:
            first.append(full_step(*args, **kwargs))
        return first[0]
    return step


def _half_batch(full_step):
    """Half of the batch left out: the step runs on the first half and the
    outputs of the rest repeat it, the histograms scaled to the whole."""
    def step(y, cb, cr, qy, qc, **kwargs):
        h = y.shape[0] // 2 or 1
        rgb, req, hists = full_step(y[:h], cb[:h], cr[:h], qy, qc, **kwargs)
        reps = -(-y.shape[0] // h)
        return (rgb.repeat(reps, 1, 1, 1)[:y.shape[0]], req.repeat(reps, 1, 1, 1)[:y.shape[0]],
                hists * y.shape[0] // h)
    return step


def _altered(row):
    """An answer altered where it is produced: one count of a histogram
    (row 1 the luma's AC, row 3 the chroma's AC)."""
    def fault(full_step):
        def step(*args, **kwargs):
            rgb, req, hists = full_step(*args, **kwargs)
            hists = hists.clone()
            hists[row, 0x01] += 1
            return rgb, req, hists
        return step
    return fault


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered(1), _altered(3)],
                         ids=["state_unchanged", "half_batch", "answer_altered",
                              "chroma_answer_altered"])
def test_broken_step_is_not_correct(checkout, monkeypatch, fault):
    from jpeglibrary_tpu_torch.parallel import sharding

    monkeypatch.setattr(sharding, "full_step", fault(sharding.full_step))
    record = _run(checkout)
    assert not record["correct"] and record["failed"] > 0, record["check"]
