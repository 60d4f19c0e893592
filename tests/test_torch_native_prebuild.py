"""The root ``conftest.py`` builds the native libraries once, in the
controller, before xdist's workers collect."""

import ctypes
import importlib.util
import os
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parent.parent


def root_conftest():
    # ``import conftest`` would find tests/conftest.py.
    spec = importlib.util.spec_from_file_location(
        "root_conftest", REPO / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_native_makes_a_fresh_loadable_library(tmp_path):
    src = tmp_path / "rle"
    src.mkdir()
    for name in ("Makefile", "rle.cc"):
        shutil.copy(REPO / "native" / "rle" / name, src / name)
    old = os.stat(src / "rle.cc").st_mtime - 60
    os.utime(src / "rle.cc", (old, old))
    root_conftest().build_native((str(src),))
    lib = src / "librle.so"
    assert lib.exists()
    assert lib.stat().st_mtime > old
    assert ctypes.CDLL(str(lib)).rle_decode_string


def test_only_the_controller_builds(monkeypatch):
    mod = root_conftest()
    calls = []
    monkeypatch.setattr(mod, "build_native", lambda: calls.append(1))

    class Worker:
        workerinput = {"workerid": "gw0"}

    class Controller:
        pass

    mod.pytest_configure(Worker())
    assert calls == []
    mod.pytest_configure(Controller())
    assert calls == [1]
    assert tuple(os.path.basename(d) for d in mod.NATIVE_DIRS) == (
        "rle", "densecrf")
