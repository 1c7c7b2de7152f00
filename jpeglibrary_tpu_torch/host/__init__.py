"""The host layers of the port: its own copy of the JAX package's
JAX-free host code, so that ``jpeglibrary_tpu_torch`` imports nothing of
``jpeglibrary_tpu``.

Each module sits at the relative path it has under ``jpeglibrary_tpu/``
(``jpeglibrary_tpu/models/decoder.py`` is ``host/models/decoder.py``)
and is a copy of it with its imports pointed here. The copies leave out
the JAX device branches, which the port replaces with its own
(``DecodeResult.to_rgb8_device``, the ``xp=jnp`` branch and the mesh of
``JpegEncoder.encode``, the JAX programs of ``ops`` and ``parallel``, the
stripe transforms of ``models/streaming.py``). The native scanner builds
from this package's own ``native/scanner.cpp``. ``utils/fixtures.py``
imports PIL only when called.
"""
