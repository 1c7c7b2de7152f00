"""Shared persistent thread pool.

Creating a ThreadPoolExecutor per decode/encode costs ~5-7 ms in OS
thread spawn + queue churn — dominating small and medium images (the
reference has no such cost: it is single-threaded). All internal
parallelism (progressive scan jobs, encoder component transforms,
restart-segment emission) runs on one lazily-created process-wide pool
instead. The pool is intentionally wider than the core count: tasks
sometimes block waiting on sibling futures (scan dependency graphs), and
spare workers prevent nested-wait starvation; idle threads cost nothing.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

_LOCK = threading.Lock()
_POOL: ThreadPoolExecutor | None = None


def shared_pool() -> ThreadPoolExecutor:
    global _POOL
    pool = _POOL
    if pool is None:
        with _LOCK:
            pool = _POOL
            if pool is None:
                workers = min(32, (os.cpu_count() or 4) * 4)
                pool = ThreadPoolExecutor(
                    max_workers=workers, thread_name_prefix="jpx"
                )
                _POOL = pool
    return pool
