"""PyTorch port, the five CLIs (``jpeglibrary_tpu_torch/cli/``): each
``main`` on synthetic images written here, against the JAX package's CLI
of the same name on the same inputs and arguments. The JPEG outputs must
be the same bytes, the PNG outputs the same pixels. (tests/test_cli.py
reads reference assets; these tests need none.)"""

import numpy as np
import pytest

pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

import jpeglibrary_tpu as jt
from jpeglibrary_tpu.cli import debugdump as ref_debugdump
from jpeglibrary_tpu.cli import decode as ref_decode
from jpeglibrary_tpu.cli import encode as ref_encode
from jpeglibrary_tpu.cli import optimize as ref_optimize
from jpeglibrary_tpu.cli import transcode as ref_transcode

from jpeglibrary_tpu_torch.cli import debugdump, decode, encode, optimize, transcode

from torch_reference_native import settle

settle()  # the JAX package's native scanner, built once before any test


def _image(h=72, w=88, seed=2):
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 255, w)[None, :, None]
    return np.clip(ramp + rng.normal(0, 16, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rgb = _image()
    png = tmp / "in.png"
    Image.fromarray(rgb, mode="RGB").save(png)
    paths = {"png": png}
    for name, data in (("baseline", jt.encode_rgb(rgb, 80)),
                       ("restart", jt.encode_rgb(rgb, 80, restart_interval=2)),
                       ("cmyk", jt.encode_cmyk(np.concatenate([rgb, rgb[..., :1]], -1), 80)),
                       ("lossless", jt.encode_lossless(rgb, predictor=1))):
        paths[name] = tmp / f"{name}.jpg"
        paths[name].write_bytes(data)
    return paths


def _both(tmp_path, port_main, ref_main, args, out_name):
    """Run the port's and the JAX package's ``main`` with ``args`` plus an
    output path each; return the two output paths."""
    outs = []
    for tag, main in (("port", port_main), ("ref", ref_main)):
        out = tmp_path / f"{tag}-{out_name}"
        assert main([str(a) for a in args[:1]] + [str(out)] + [str(a) for a in args[1:]]) == 0
        outs.append(out)
    return outs


@pytest.mark.parametrize("flags", [[], ["--optimize-coding"], ["--most-optimal"],
                                   ["--subsampling", "444", "--quality", "95"],
                                   ["--restart-interval", "3"]], ids=str)
def test_encode_cli_matches_jax(inputs, tmp_path, flags):
    port, ref = _both(tmp_path, encode.main, ref_encode.main, [inputs["png"], *flags], "o.jpg")
    assert port.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("source,flags", [
    ("baseline", []), ("baseline", ["--fancy-upsampling"]), ("baseline", ["--metrics"]),
    ("restart", ["--region", "8,16,40,24"]), ("cmyk", ["--cmyk"]), ("lossless", []),
], ids=str)
def test_decode_cli_matches_jax(inputs, tmp_path, source, flags):
    out = "o.tif" if source == "cmyk" else "o.png"  # PIL writes no CMYK PNG
    port, ref = _both(tmp_path, decode.main, ref_decode.main, [inputs[source], *flags], out)
    with Image.open(port) as a, Image.open(ref) as b:
        assert a.mode == b.mode and a.size == b.size
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("flags", [[], ["--no-strip"], ["--standard-tables"]], ids=str)
def test_optimize_cli_matches_jax(inputs, tmp_path, flags):
    port, ref = _both(tmp_path, optimize.main, ref_optimize.main, [inputs["baseline"], *flags],
                      "o.jpg")
    assert port.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("source,flags", [
    ("baseline", []), ("baseline", ["--mode", "progressive"]),
    ("baseline", ["--mode", "arithmetic", "--restart-interval", "2"]),
    ("baseline", ["--transform", "rot90", "--trim"]),
    ("baseline", ["--crop", "8", "8", "40", "32"]), ("lossless", ["--predictor", "4"]),
], ids=str)
def test_transcode_cli_matches_jax(inputs, tmp_path, source, flags):
    port, ref = _both(tmp_path, transcode.main, ref_transcode.main, [inputs[source], *flags],
                      "o.jpg")
    assert port.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("source", ["baseline", "lossless"])
def test_debugdump_cli_matches_jax(inputs, tmp_path, source):
    prefixes = [tmp_path / "port", tmp_path / "ref"]
    for main, prefix in zip((debugdump.main, ref_debugdump.main), prefixes):
        assert main([str(inputs[source]), "--output-prefix", str(prefix)]) == 0
    for suffix in (".high.png", ".low-diff.png"):
        with Image.open(f"{prefixes[0]}{suffix}") as a, Image.open(f"{prefixes[1]}{suffix}") as b:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
