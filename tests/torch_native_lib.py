"""The reference's native planner (``mfx.native``) for the port's tests that
hold their results against it.

``mfx.native`` builds its shared library on first use, with no lock
between processes: ``g++ -o`` writes straight to the final path, and a
process that loads the file while another is still writing it (or whose
own build fails) keeps ``_tried`` set and the NumPy fallback for the rest
of its life. Under ``pytest -n`` every worker builds or loads it, so one
worker can lose that race for good. :func:`native_lib` serialises the
port's tests' build and load with an ``fcntl.flock`` across the workers
and, where this process's earlier attempt failed, clears that state and
loads again; the caller then asserts ``native.available()`` as before.
"""

import fcntl
import os
import tempfile
import time

# a writer that does not take the lock (the JAX package's own tests
# build the library at collection) needs a few seconds to finish
_RETRIES, _WAIT_S = 30, 1.0


def native_lib():
    """``mfx.native`` with its library loaded where a C++ compiler can
    build it."""
    from mfx import native

    path = os.path.join(tempfile.gettempdir(), "mfx_native_build.lock")
    with open(path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for attempt in range(_RETRIES):
                if native.available():
                    break
                if attempt:
                    time.sleep(_WAIT_S)
                with native._lock:
                    native._lib, native._tried = None, False
                native.get_lib()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return native
