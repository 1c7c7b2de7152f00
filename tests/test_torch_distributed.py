"""PyTorch port, ``parallel/distributed.py``: two processes join one gloo
group through ``initialize`` (as tests/test_distributed.py runs its JAX
workers: ``python -c`` with a rank and a port), and each decodes its
``local_batch_block`` of 4 synthetic same-geometry JPEGs through
``decode_batch_rgb_global``; each rank's shard is held to the JAX
package's ``decode_batch_rgb_global`` of the same images (run in the test
process on the virtual CPU devices) and to the port's single-process
``decode_batch_rgb`` of its images, on the v2 wire and when one rank
scans the v1 wire (the one-int gathers then put every rank on the v1
plane-order branch, which JAX takes under ``JPX_WIRE=1``). The workers
load nothing of JAX."""

import math
import pathlib
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jpeglibrary_tpu_torch as jtt
from jpeglibrary_tpu_torch.parallel import distributed

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 120  # seconds for the whole world; a hung rendezvous fails this test alone

_WORKER = textwrap.dedent(
    """
    import pickle, sys
    pid, port, inputs, output = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    sys.path[:0] = sys.argv[5:7]
    from jpeglibrary_tpu_torch.parallel import distributed
    distributed.initialize(f"127.0.0.1:{port}", 2, pid, backend="gloo")
    import torch_mesh_workers
    with open(inputs, "rb") as f:
        datas = pickle.load(f)
    result = torch_mesh_workers.global_batch(datas)
    with open(output, "wb") as f:
        pickle.dump(result, f)
    """
)


def _datas():
    rng = np.random.default_rng(4)
    base = np.clip(np.linspace(0, 255, 64)[None, :, None] + rng.normal(0, 12, (48, 64, 3)),
                   0, 255).astype(np.uint8)
    variants = [base, base[::-1], base[:, ::-1], np.roll(base, 16, axis=0)]
    return [jtt.encode_rgb(np.ascontiguousarray(v), q, device="cpu")
            for v, q in zip(variants, (90, 80, 70, 60))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distributed")
    inputs = tmp / "datas.pkl"
    inputs.write_bytes(pickle.dumps(_datas()))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(i), str(port), str(inputs),
                               str(tmp / f"rank{i}.pkl"), str(ROOT), str(ROOT / "tests")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {i} failed:\n{log[-3000:]}"
    return [pickle.loads((tmp / f"rank{i}.pkl").read_bytes()) for i in range(2)]


def test_initialize_joins_the_world(ranks):
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
    assert all(r["jax_modules"] == [] for r in ranks)


def test_local_batch_assignment(ranks):
    assert [r["block"] for r in ranks] == [[0, 1], [2, 3]]
    assert [r["indices"] for r in ranks] == [[0, 2, 4], [1, 3]]


@pytest.fixture(scope="module")
def jax_global():
    """The JAX package's ``decode_batch_rgb_global`` of the 4 images in one
    process, on the v2 wire ("shard") and under ``JPX_WIRE=1`` ("mixed":
    the v1 plane-order branch); the batch repeats to divide the devices."""
    import os

    import jax
    from jpeglibrary_tpu.parallel import decode_batch_rgb_global

    datas = _datas()
    datas = datas * (math.lcm(len(datas), len(jax.devices())) // len(datas))
    out = {"shard": np.asarray(decode_batch_rgb_global(datas))[:4]}
    os.environ["JPX_WIRE"] = "1"
    try:
        out["mixed"] = np.asarray(decode_batch_rgb_global(datas))[:4]
    finally:
        os.environ.pop("JPX_WIRE", None)
    return out


@pytest.mark.parametrize("key", ["shard", "mixed"])
def test_global_batch_shards_equal_single_process_decode(ranks, jax_global, key):
    datas = _datas()
    for r in ranks:
        assert r["global_shape"] == (4, 3, 48, 64)
        assert r[key].shape == (2, 3, 48, 64)
        # XLA:CPU contracts the float IDCT differently per compiled shape:
        # 1 LSB on rare values, the tolerance of tests/test_parallel.py.
        d = np.abs(r[key].astype(np.int64) - jax_global[key][r["block"]].astype(np.int64))
        assert d.max() <= 1 and (d > 0).mean() < 1e-4, (d.max(), (d > 0).mean())
        want = jtt.decode_batch_rgb([datas[i] for i in r["block"]], device="cpu")
        for got, w in zip(r[key], want):
            np.testing.assert_array_equal(np.moveaxis(got, 0, -1), w)


def test_single_process_is_no_world():
    distributed.initialize("127.0.0.1:1", 1, 0)  # a no-op at one process, as JAX's
    assert not torch.distributed.is_initialized()
    assert distributed.local_batch_block(4) == range(0, 4)
    assert list(distributed.local_batch_indices(3)) == [0, 1, 2]
