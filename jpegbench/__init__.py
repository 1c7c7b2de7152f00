"""The benchmark of jpeglibrary_tpu_torch on an NVIDIA H100.

``python3 jpegbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` from the root of a
checkout. Everything that belongs to one configuration, traffic mix,
entry or per-layer metric lies in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json`` (which names its
entry), ``entries/<entry>.py``, ``metrics/<metric>.py`` and
``limits/<workload>.json``. ``reference/`` is the plain PyTorch
reference that decides ``correct``; it imports nothing of the port.
Nothing here imports JAX or the JAX package.
"""
