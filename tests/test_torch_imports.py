"""PyTorch port, import hygiene: the port runs without JAX (the machine
with the GPU has neither JAX nor PIL) and without the JAX package (it
carries its own host layers), and hands its product to no library
kernel."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "jpeglibrary_tpu_torch"


def test_cpu_slice_loads_neither_jax_nor_pil(tmp_path):
    """Every CPU entry point of the port runs in a process where JAX, PIL
    and the JAX package cannot be imported (the card's machine has
    neither JAX nor PIL, and the port stands alone); its streams are
    written here by the JAX package."""
    import numpy as np

    import jpeglibrary_tpu as jt

    rng = np.random.default_rng(0)
    rgb = np.clip(np.linspace(0, 255, 64)[None, :, None]
                  + rng.normal(0, 30, (48, 64, 3)), 0, 255).astype(np.uint8)
    np.save(tmp_path / "rgb.npy", rgb)
    (tmp_path / "base.jpg").write_bytes(jt.encode_rgb(rgb, 75))
    (tmp_path / "arith.jpg").write_bytes(jt.encode_rgb(rgb, 75, arithmetic=True))
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'PIL', 'jpeglibrary_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import pathlib\n"
        "import numpy as np\n"
        "import jpeglibrary_tpu_torch as jtt\n"
        f"d = pathlib.Path({str(tmp_path)!r})\n"
        "rgb = np.load(d / 'rgb.npy')\n"
        "data, arith = (d / 'base.jpg').read_bytes(), (d / 'arith.jpg').read_bytes()\n"
        "out = list(jtt.decode_stream_rgb([data, data], device='cpu'))\n"
        "assert [tuple(o.shape) for o in out] == [(3, 48, 64)] * 2\n"
        "out = list(jtt.decode_stream_rgb([data, data, arith], device='cpu', group=2,\n"
        "                                 scale=0.5))\n"
        "assert [tuple(o.shape) for o in out] == [(3, 24, 32)] * 3\n"
        "out = jtt.decode_batch_rgb([data, arith], device='cpu', scale=0.25)\n"
        "assert [o.shape for o in out] == [(12, 16, 3)] * 2\n"
        "ours = jtt.encode_rgb(rgb, 75, device='cpu')\n"
        "assert jtt.decode(ours).to_rgb8().shape == (48, 64, 3)\n"
        "plane = (rgb[..., 0].astype(np.int32) * 16)\n"
        "ours = jtt.encode_gray(plane, 90, device='cpu', precision=12)\n"
        "assert jtt.decode(ours).precision == 12\n"
        "res = jtt.decode(data, sparse_direct=True)\n"
        "assert jtt.to_rgb8_device(res, device='cpu', upsample='fancy').shape == (3, 48, 64)\n"
        "q = jtt.models.decoder.quant_tables(res)\n"
        "u16 = jtt.transform_mcu2(res.packed_mcu2, q, res.geometry, 'cpu', output='u16')\n"
        "assert tuple(u16.shape) == (48, 64, 3)\n"
        "stripes = [s for _, s in jtt.decode_rgb_stripes(data, device='cpu', stripe_mcu_rows=1)]\n"
        "assert len(stripes) == 3\n"
        "ink = np.concatenate([rgb, rgb[..., :1]], -1)\n"
        "assert jtt.decode(jtt.encode_cmyk(ink, 75, device='cpu', ycck=True)).width == 64\n"
        "assert len(jtt.encode_batch_rgb([rgb, rgb], device='cpu')) == 2\n"
        "assert jtt.decode_region(data, 8, 8, 16, 16).shape == (16, 16, 3)\n"
        "import torch\n"
        "cpu = torch.device('cpu')\n"
        "assert jtt.decode_region(data, 8, 8, 16, 16, xp=cpu).shape == (16, 16, 3)\n"
        "assert jtt.decode(arith, xp=cpu).planes[0].shape == (48, 64)\n"
        "from jpeglibrary_tpu_torch.host.ops.pipeline import pack_sparse\n"
        "dense = jtt.decode(data)\n"
        "packed = pack_sparse(dense.coefficients, dense.geometry)\n"
        "out = jtt.transform_packed(packed, q, dense.geometry, 'cpu')\n"
        "assert tuple(out.shape) == (3, 48, 64)\n"
        "from jpeglibrary_tpu_torch.ops import encode_stage\n"
        "z = encode_stage.fdct_quantize_butterfly(torch.zeros(16, 16, dtype=torch.int32),\n"
        "                                         torch.ones(64, dtype=torch.int32))\n"
        "assert tuple(z.shape) == (2, 2, 64)\n"
        "assert jtt.decode(jtt.transform(data, 'rot90')).width == 48\n"
        "assert len(jtt.optimize(data)) < len(data)\n"
        "from jpeglibrary_tpu_torch.ops import device_scan\n"
        "ri2 = jtt.encode_rgb(rgb, 75, device='cpu', restart_interval=2)\n"
        "coeffs, geo = device_scan.decode_baseline_device(ri2, device='cpu')\n"
        "assert tuple(coeffs.shape) == (6, 2 * 6 * 64)\n"
        "from jpeglibrary_tpu_torch.parallel import full_step\n"
        "y, c = np.zeros((1, 4, 4, 64), np.int16), np.zeros((1, 2, 2, 64), np.int16)\n"
        "q = np.ones(64, np.int32)\n"
        "out, requant, hists = full_step(y, c, c, q, q, device='cpu')\n"
        "assert tuple(out.shape) == (1, 32, 32, 3) and int(hists[0].sum()) == 16\n"
        "from jpeglibrary_tpu_torch import graft_entry\n"
        "from jpeglibrary_tpu_torch.cli import debugdump, decode, encode, optimize, transcode\n"
        "from jpeglibrary_tpu_torch.parallel import collectives, distributed, sharding\n"
        "step, args = graft_entry.entry(device='cpu')\n"
        "assert int(step(*args)[2][0].sum()) == args[0].numel() // 64\n"
        "assert distributed.local_batch_block(4) == range(4)\n"
        "import contextlib, io\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert optimize.main([str(d / 'base.jpg'), str(d / 'opt.jpg')]) == 0\n"
        "print(sorted(m for m in ('jax', 'jaxlib', 'PIL', 'jpeglibrary_tpu')\n"
        "             if sys.modules.get(m) is not None))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_chip_smoke_imports_only_the_port():
    """The card check reaches the repo only through the port: no JAX, no
    PIL and nothing of the JAX package by import of its own."""
    lines = (ROOT / "chip_smoke.py").read_text().splitlines()
    imports = [ln.strip() for ln in lines if re.match(r"\s*(import|from)\s", ln)]
    assert any("jpeglibrary_tpu_torch" in ln for ln in imports)
    hits = [ln for ln in imports
            if re.match(r"(import|from)\s+(jax|jaxlib|PIL|jpeglibrary_tpu)\b", ln)]
    assert not hits, hits


@pytest.mark.parametrize("pattern", [
    r"^\s*(import\s+jax|from\s+jax[\s.])",
    r"torch\.compile",
    r"scaled_dot_product_attention",
])
def test_port_sources_free_of(pattern):
    sources = sorted(PORT.rglob("*.py")) + sorted((PORT / "csrc").glob("*.cu"))
    assert sources
    hits = [
        f"{p.relative_to(ROOT)}:{i}"
        for p in sources
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if re.search(pattern, line)
    ]
    assert not hits, hits


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in PORT.rglob("*.py")))
def test_port_module_imports_nothing_of_the_jax_package(path):
    """No module of the port imports ``jpeglibrary_tpu`` (as opposed to
    ``jpeglibrary_tpu_torch``), at its top or inside a function."""
    pattern = re.compile(r"^\s*(import|from)\s+jpeglibrary_tpu(?!_torch)\b")
    hits = [f"{path}:{i}" for i, line in enumerate((ROOT / path).read_text().splitlines(), 1)
            if pattern.match(line)]
    assert not hits, hits


MESH_MODULES = ["jpeglibrary_tpu_torch.parallel.collectives",
                "jpeglibrary_tpu_torch.parallel.distributed",
                "jpeglibrary_tpu_torch.parallel.sharding", "jpeglibrary_tpu_torch.graft_entry",
                *(f"jpeglibrary_tpu_torch.cli.{name}"
                  for name in ("decode", "encode", "optimize", "transcode", "debugdump"))]


def test_spawned_ranks_load_neither_jax_nor_the_jax_package():
    """A rank spawned by ``distributed.spawn`` (from this process, which
    has JAX loaded) imports the mesh modules, the CLIs and the tests' rank
    functions (``tests/torch_mesh_workers.py``) and finds no JAX module
    and nothing of the JAX package loaded."""
    import torch_mesh_workers

    from jpeglibrary_tpu_torch.parallel import distributed

    loaded = distributed.spawn(torch_mesh_workers.imported_modules, 2, MESH_MODULES,
                               backend="gloo", timeout=120)
    assert loaded == [[], []]


def test_rank_functions_import_nothing_of_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|jpeglibrary_tpu(?!_torch))\b")
    text = (ROOT / "tests" / "torch_mesh_workers.py").read_text().splitlines()
    hits = [i for i, line in enumerate(text, 1) if pattern.match(line)]
    assert not hits, hits
