"""The JAX package's native scanner, built once per machine before any test
runs.

The reference's build (``jpeglibrary_tpu/native/build.py``) compiles every
process into one temporary file and renames it into place. A test process
that builds it while another does can lose the rename, or load a library
that the other is still writing; the reference keeps that failure for the
rest of the process, so its native tests skip there and its decodes run
without the scanner.

Every test module of the port that imports the JAX package calls
:func:`settle` while it is imported. Each pytest-xdist worker imports every
test module while it collects, and the controller schedules no test before
every worker has collected: so the first worker compiles under an
exclusive ``flock``, the others wait on the lock and load the finished
library, and no test of any worker meets a half-built one. The JAX package
is not changed. This module imports no JAX.
"""

from __future__ import annotations

import fcntl
import shutil
import time

from jpeglibrary_tpu.native import build as ref_build

ATTEMPTS = 60  # loads tried under the lock, WAIT_S apart
WAIT_S = 1.0


def settle(attempts: int = ATTEMPTS, wait_s: float = WAIT_S):
    """Build (under the lock) and load the reference's scanner; return the
    library, or None where the reference itself would fall back without
    it (no ``g++`` and no library built). A failure the reference recorded
    earlier in this process is cleared and the load tried again, up to
    ``attempts`` times, until a build by another process has settled.
    Never raises: a test that needs the scanner calls ``load_library``."""
    if ref_build._LIB is not None:
        return ref_build._LIB
    out_dir = ref_build._build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    no_compiler = shutil.which("g++") is None
    with open(out_dir / "reference-build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for attempt in range(attempts):
            if ref_build._LIB is None:
                ref_build._FAILED = None
            try:
                return ref_build.load_library()
            except ImportError:
                if no_compiler or attempt == attempts - 1:
                    return None
                time.sleep(wait_s)
    return None
