"""PyTorch port, ``graft_entry.py``: ``entry(device="cpu")`` gives the
flagship step and its example inputs, and the step equals the JAX
package's ``__graft_entry__`` step on the same inputs (integer outputs
exactly, RGB within 1 level on <= 1e-4 of the values, the
tests/test_torch_full_step.py tolerance); ``dryrun_multichip(4,
device_type="cpu")`` runs its checks in 4 gloo ranks (a 2 x 2 mesh) and
passes."""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from jpeglibrary_tpu_torch import graft_entry


def test_entry_runs_the_step_on_the_cpu():
    step, args = graft_entry.entry(device="cpu")
    assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu" for a in args)
    rgb, requant, hists = step(*args)
    y = args[0]
    assert tuple(rgb.shape) == (y.shape[0], y.shape[1] * 8, y.shape[2] * 8, 3)
    assert int(hists[0].sum()) == y.numel() // 64  # one DC symbol per luma block

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    import __graft_entry__ as ref_entry

    ref_fn, ref_args = ref_entry.entry()
    for a, b in zip(args, ref_args):
        np.testing.assert_array_equal(a.numpy(), b)
    want = [np.asarray(x) for x in jax.jit(ref_fn)(*ref_args)]
    d = np.abs(rgb.numpy().astype(np.int64) - want[0])
    assert d.max() <= 1 and (d > 0).sum() <= d.size * 1e-4
    np.testing.assert_array_equal(requant.numpy(), want[1])
    np.testing.assert_array_equal(hists.numpy(), want[2])


def test_dryrun_multichip_on_cpu_ranks():
    launches = graft_entry.dryrun_multichip(4, device_type="cpu")
    assert launches == [{"k1": 0, "k2": 0}] * 4  # CPU ranks take the plain versions
