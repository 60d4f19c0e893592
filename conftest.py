"""Build the repo's native libraries once, before pytest's workers start.

``tests/test_rle_native.py`` and ``tests/test_crf_native.py`` decide at
collection whether their library loads, and loading runs ``make`` in
``native/``. Under xdist every worker collects at once, so without this
hook six ``make``s write one ``.so`` together and a worker that loads the
half-written file skips the module. Here the controller (or a run without
xdist) builds each library first; the workers' own ``make`` then finds it
fresh and writes nothing. A failed build raises nothing: the modules'
``skipif`` decides, as without this hook.

Imports neither JAX nor the repo's packages, so ``--noconftest`` runs on
the card and ``port_bench/tests`` see no change.
"""

from __future__ import annotations

import os
import subprocess

NATIVE_DIRS = tuple(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", name)
    for name in ("rle", "densecrf"))


def build_native(dirs=NATIVE_DIRS) -> None:
    """``make -C dir`` for each of ``dirs``; failures are left to the
    tests that load the library."""
    for path in dirs:
        try:
            subprocess.run(["make", "-C", path], capture_output=True)
        except OSError:  # no make on PATH
            pass


def pytest_configure(config):
    # An xdist worker carries ``workerinput``; its controller has built.
    if not hasattr(config, "workerinput"):
        build_native()
