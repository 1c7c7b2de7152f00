"""``k6_roofline.recompress`` on made-up Chrome trace events: K6's time over
the complete steps against its bound, the bound counted by hand at both
cells' shapes, and None for a program that launches no K6 (the parent of
the change that brought it) or without a trace."""

import pytest

from jpegbench.core import spec
from jpegbench.core.harness import Context
from jpegbench.core.peaks import bound_s
from jpegbench.core.trace import STEP, WINDOW, Trace

NAME = "k6_roofline.recompress"
HET = {"batch": 4, "width": 4096, "height": 4096, "hb": 512, "wb": 512}
NET = {"batch": 256, "width": 500, "height": 375, "hb": 48, "wb": 64}
K6 = "color_round_trip_kernel(int4 const*, int4 const*, int4 const*, unsigned char*)"
TINY = {"batch": 1, "width": 16, "height": 16, "hb": 2, "wb": 2}  # 256 pixels


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _events(kernels, drop=()):
    """A 1,000 us window of 3 steps, each launching ``kernels`` ((name,
    duration in us)) back to back on the device from t = 100 us; ``drop``
    leaves out device records by correlation id."""
    events = [_span(WINDOW, 0, 1000)]
    corr, at = 0, 100.0
    for i in range(3):
        events.append(_span(STEP, 10 * i, 5))
        for name, dur in kernels:
            corr += 1
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": 10 * i + 1, "dur": 1, "args": {"correlation": corr}})
            if corr not in drop:
                events.append({"ph": "X", "cat": "kernel", "name": name, "ts": at, "dur": dur,
                               "args": {"correlation": corr}})
            at += dur
    return events


def _read(events, shape=TINY):
    trace = None if events is None else Trace(events)
    return spec.metric_reader(NAME)(Context(None, shape, None, trace))


@pytest.mark.parametrize("shape,n_bytes,ops", [
    # 67,108,864 pixels x 12 B; 32 operations a pixel and 17 a 2x2 cell.
    (HET, 805_306_368, 67_108_864 * 32 + 16_777_216 * 17),
    # 50,331,648 pixels (512 x 384 padded, 256 images).
    (NET, 603_979_776, 50_331_648 * 32 + 12_582_912 * 17),
], ids=["recompress_16mp_b4", "recompress_imagenet_b256"])
def test_work_count(shape, n_bytes, ops):
    module = spec.metric_reader(NAME).__globals__
    assert module["step_bound_s"](shape) == pytest.approx(bound_s(n_bytes, 0, ops))
    assert module["step_bound_s"](shape) == pytest.approx(n_bytes / 3.35e12)  # bytes bound it


def test_reads_k6_over_the_complete_steps():
    bound = spec.metric_reader(NAME).__globals__["step_bound_s"](TINY)
    kernels = (("dequant_idct_kernel<short, 64>", 30), (K6, 4 * bound * 1e6),
               ("fdct_quant_kernel", 10))
    assert _read(_events(kernels)) == pytest.approx(25.0)
    # A step with a dropped record (step 1's K1) is left out, K6's own too.
    assert _read(_events(kernels, drop={4})) == pytest.approx(25.0)
    assert _read(_events(kernels, drop={5})) == pytest.approx(25.0)


def test_reads_none_without_k6():
    """The parent's step runs the plain colour ops: no K6 record, no reading."""
    parent = (("dequant_idct_kernel<short, 64>", 30),
              ("vectorized_elementwise_kernel<4, AddFunctor<int>>", 200))
    assert _read(_events(parent)) is None
    assert _read(None) is None
