"""PyTorch port, K1 (dequantize + IDCT): its plain version against the
JAX package's Pallas kernel (interpret mode, the JAX tests' own CPU
route) and against the butterfly IDCT, and the wrapper's dispatch.

Tolerance: 1 sample LSB. The folded-matrix product sums in another order
than the butterfly (and than XLA's dot), so a value within an ulp of a
.5 tie can round the other way. The share of samples that differ is
bounded too: a plain version that truncated, or lost mantissa bits,
would be off by 1 on about half of them."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from jpeglibrary_tpu.ops import decode_stage as ref_stage
from jpeglibrary_tpu.ops import pallas_kernels
from jpeglibrary_tpu_torch.ops import decode_stage, kernels


def _inputs(n_blocks, seed=5):
    rng = np.random.default_rng(seed)
    coeffs = rng.integers(-1024, 1024, size=(n_blocks, 64)).astype(np.int16)
    quant = rng.integers(1, 255, size=64).astype(np.int32)
    return coeffs, quant


def _plain(coeffs, quant, level_shift):
    matrix = torch.from_numpy(kernels.fused_transform_matrix())
    return decode_stage.dequantize_idct_shift(
        torch.from_numpy(coeffs), torch.from_numpy(quant), len(coeffs), level_shift, matrix
    ).numpy()


@pytest.mark.parametrize("level_shift", [128, 2048])
@pytest.mark.parametrize("n_blocks", [1, 64, 513])
def test_plain_matches_pallas_interpret(n_blocks, level_shift):
    coeffs, quant = _inputs(n_blocks)
    want = np.asarray(
        pallas_kernels.dequantize_idct_shift_pallas(
            jnp.asarray(coeffs), jnp.asarray(quant), level_shift, interpret=True
        )
    )
    got = _plain(coeffs, quant, level_shift)
    assert got.shape == want.shape == (n_blocks, 8, 8)
    d = np.abs(got.astype(np.int64) - want)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("level_shift", [128, 2048])
@pytest.mark.parametrize("n_blocks", [1, 64, 513])
def test_plain_matches_butterfly(n_blocks, level_shift):
    coeffs, quant = _inputs(n_blocks, seed=7)
    want = ref_stage.dequantize_idct_shift(coeffs, quant, level_shift)
    got = _plain(coeffs, quant, level_shift)
    assert got.dtype == np.int32 and got.shape == want.shape
    d = np.abs(got.astype(np.int64) - want)
    # These inputs reach samples of ~1e5, where fp32's ulp is ~1e-2, so
    # the two summation orders round about 1% of the samples apart.
    assert d.max() <= 1 and (d > 0).mean() <= 2e-2, (d.max(), (d > 0).mean())


def test_transform_matrix_equals_jax_package():
    ours = kernels.transform_matrix(torch.device("cpu"))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (64, 64)
    np.testing.assert_array_equal(ours.numpy(), pallas_kernels.fused_transform_matrix())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
def test_wrapper_on_cpu_takes_plain_version(dtype):
    coeffs, quant = _inputs(70, seed=9)
    c = torch.from_numpy(coeffs).to(dtype).reshape(7, 10, 64)
    before = kernels.dequantize_idct_shift.launches
    got = kernels.dequantize_idct_shift(c, torch.from_numpy(quant), 128)
    assert kernels.dequantize_idct_shift.launches == before
    assert got.shape == (7, 10, 8, 8) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.reshape(70, 8, 8).numpy(), _plain(coeffs, quant, 128))


def test_wrapper_rejects_bad_inputs():
    coeffs, quant = _inputs(4)
    c = torch.from_numpy(coeffs)
    q = torch.from_numpy(quant)
    with pytest.raises(TypeError):
        kernels.dequantize_idct_shift(c.to(torch.float32), q, 128)
    with pytest.raises(ValueError):
        kernels.dequantize_idct_shift(c[:, :63], q, 128)
    with pytest.raises(ValueError):
        kernels.dequantize_idct_shift(c, q[:32], 128)
    with pytest.raises(ValueError):
        kernels.dequantize_idct_shift(c, q.to(torch.int64), 128)
    with pytest.raises(ValueError):
        kernels.dequantize_idct_shift(c.to("meta"), q.to("meta"), 128)


def test_import_needs_no_nvcc_or_triton(tmp_path):
    """The modules import, and the CPU path runs, with no nvcc anywhere;
    asking for the CUDA build then raises with a clear message."""
    code = (
        "import sys, torch\n"
        "from jpeglibrary_tpu_torch.ops import _build, kernels\n"
        "c = torch.zeros(3, 64, dtype=torch.int32)\n"
        "q = torch.ones(64, dtype=torch.int32)\n"
        "assert (kernels.dequantize_idct_shift(c, q, 128) == 128).all()\n"
        "assert 'triton' not in sys.modules\n"
        "import os\n"
        "if not os.path.exists('/usr/local/cuda/bin/nvcc'):\n"
        "    try:\n"
        "        _build.find_nvcc()\n"
        "    except RuntimeError as e:\n"
        "        assert 'nvcc not found' in str(e)\n"
        "    else:\n"
        "        raise AssertionError('find_nvcc found a compiler')\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"
