"""The user scripts' port twins: the shell scripts carry their JAX
scripts' flags on ``pnp_ovss_tpu_torch``, and the accuracy gate
(``scripts/accuracy_gate_torch.py``) runs end to end on the CPU.

The shell scripts run under ``bash`` with a stand-in ``python`` first on
``PATH`` that records its arguments, so each twin's command line is held
against its JAX script's: the same flags and values, the port's module,
and ``--device`` (``cuda`` unless ``DEVICE`` says otherwise).

The gate runs in-process: its ``run_segment`` is replaced by the port's
``cli.segment.main`` at the tiny model widths of ``tests/test_torch_cli.py``
over that file's fake VOC directory and tiny LAVIS-layout checkpoint, with
``--device cpu``. Random weights: the run checks the gate's machinery,
not accuracy.
"""

import importlib.util
import json
import os
import subprocess
from pathlib import Path

import pytest

from pnp_ovss_tpu_torch import config as pcfg_mod
from pnp_ovss_tpu_torch.cli import segment as port_cli
from tests.test_torch_cli import ARGS, _checkpoint, _fake_voc, \
    _tiny_build_config

REPO = Path(__file__).resolve().parent.parent


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _commands(tmp_path, script, args, env=None):
    """The ``python`` command lines ``script`` runs, each a list of its
    arguments."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    log = tmp_path / "calls.txt"
    log.unlink(missing_ok=True)
    fake = bin_dir / "python"
    fake.write_text("#!/bin/bash\n"
                    "printf '%s\\0' \"$@\" >> \"$CALLS\"\n"
                    "printf '\\n' >> \"$CALLS\"\n")
    fake.chmod(0o755)
    run_env = {k: v for k, v in os.environ.items() if k != "DEVICE"}
    run_env.update(PATH=f"{bin_dir}:{os.environ['PATH']}", CALLS=str(log),
                   **(env or {}))
    subprocess.run(["bash", str(REPO / "scripts" / script)] + args,
                   check=True, env=run_env, cwd=REPO, timeout=60)
    return [line.rstrip("\0").split("\0")
            for line in log.read_text().splitlines() if line]


SEG = ["voc", "/data/home", "/out/seg", "/ckpt/model.pth", "/ckpt/vocab.txt"]
GATE_ENV = {"CKPT": "/ckpt/model.pth", "VOCAB": "/ckpt/vocab.txt",
            "DATA": "/data/home", "OUT": "/out/gate"}


@pytest.mark.parametrize("jax_script,args,env", [
    ("run_seg.sh", SEG, {}),
    ("run_seg.sh", SEG[:3], {"DEVICE": "cpu"}),
    ("run_seg_coco.sh", ["coco_object"] + SEG[1:], {}),
    ("calculate_miou.sh", ["/out/seg", "voc"], {}),
    ("run_accuracy_gate.sh", ["--limit", "200"], GATE_ENV),
])
def test_shell_twins_carry_the_jax_flags(tmp_path, jax_script, args, env):
    port_script = jax_script.replace(".sh", "_torch.sh")
    want = _commands(tmp_path, jax_script, args, env)
    got = _commands(tmp_path, port_script, args, env)
    if jax_script == "run_accuracy_gate.sh":
        # The JAX gate first runs the torch-oracle check of the JAX
        # package; the port's does not.
        assert want[0][:2] == ["-m", "pytest"]
        want = want[1:]
        want[0][0] = "scripts/accuracy_gate_torch.py"
    else:
        assert want[0][:2] == ["-m", want[0][1]]
        assert want[0][1].startswith("pnp_ovss_tpu.")
        want[0][1] = want[0][1].replace("pnp_ovss_tpu.",
                                        "pnp_ovss_tpu_torch.", 1)
    assert len(got) == len(want) == 1
    got, want = got[0], want[0]
    if jax_script == "calculate_miou.sh":
        assert got == want  # host only: no device
        return
    i = got.index("--device")
    assert got[i + 1] == env.get("DEVICE", "cuda")
    assert got[:i] + got[i + 2:] == want


def test_gate_grid_is_the_jax_gates():
    assert _load("accuracy_gate_torch").DEVICE_GRID == \
        _load("accuracy_gate").DEVICE_GRID


@pytest.fixture(scope="module")
def gate_run(tmp_path_factory):
    """The gate over the fake VOC set on the CPU; every CLI run in-process
    at the tiny widths (bucket 32 in place of the grid's 224 / 192)."""
    root = tmp_path_factory.mktemp("gate")
    mp = pytest.MonkeyPatch()
    mp.setenv("HOME", str(root / "home"))
    mp.setattr(port_cli, "build_config",
               _tiny_build_config(port_cli.build_config, pcfg_mod))
    gate = _load("accuracy_gate_torch")
    argvs = []

    def in_process(argv):
        argvs.append(list(argv))
        port_cli.main(list(argv) + ARGS[2:])

    mp.setattr(gate, "run_segment", in_process)
    home = _fake_voc(root / "voc")
    flags = ["--checkpoint", _checkpoint(root / "model.pth"), "--home_dir",
             home, "--save_path", str(root / "out"), "--batch_size", "4",
             "--device", "cpu"]
    payload = gate.main(flags + ["--budget", "100"])
    yield dict(gate=gate, flags=flags, argvs=argvs, payload=payload,
               out=root / "out")
    mp.undo()


def test_gate_writes_the_anchor_and_the_grid(gate_run):
    payload = json.loads((gate_run["out"] / "gate_results.json").read_text())
    assert payload == gate_run["payload"]
    tags = [t for t, *_ in gate_run["gate"].DEVICE_GRID]
    assert list(payload["miou"]) == ["parity_host"] + tags
    assert all(0 <= m <= 1 for m in payload["miou"].values())
    assert payload["failures"] == [] and payload["device"] == "cpu"
    argvs = gate_run["argvs"]
    assert len(argvs) == 5
    assert all(a[a.index("--device") + 1] == "cpu" for a in argvs)
    assert argvs[0][-2:] == ["--postprocess_backend", "host"]
    for argv, (tag, mode, sub, bucket) in zip(argvs[1:],
                                              gate_run["gate"].DEVICE_GRID):
        assert argv[argv.index("--save_path") + 1].endswith(tag)
        assert argv[-6:] == ["--bucket_size", str(bucket), "--crf_mode",
                             mode, "--crf_subsample", str(sub)]


def test_gate_fails_past_its_budget(gate_run):
    """A budget no delta can meet (mIoU up by 100 points): every grid
    config fails and the gate exits naming them. The CLI runs resume, so
    the hist files are read again, not recomputed."""
    n = len(gate_run["argvs"])
    with pytest.raises(SystemExit) as err:
        gate_run["gate"].main(gate_run["flags"] + ["--budget", "-100"])
    for tag, *_ in gate_run["gate"].DEVICE_GRID:
        assert tag in str(err.value)
    assert len(gate_run["argvs"]) == n + 5
    payload = json.loads((gate_run["out"] / "gate_results.json").read_text())
    assert payload["failures"] == [t for t, *_ in
                                   gate_run["gate"].DEVICE_GRID]
    assert payload["miou"] == gate_run["payload"]["miou"]
