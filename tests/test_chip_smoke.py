"""chip_smoke.py's contract, checked on the CPU: its rehearsal runs every
phase at tiny sizes in-process, and it refuses to report without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

sys.path.insert(0, ".")
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("args", [[], ["--cards", "4"]])
def test_cpu_rehearsal(capsys, args):
    assert chip_smoke.main(["--cpu-rehearsal", *args]) == 0
    out = capsys.readouterr().out.splitlines()
    last = json.loads(out[-1])
    assert last["ok"] is True
    assert last["device"]["platform"] == "cpu"
    assert last["device"]["count"] >= 4
    phases = [line for line in out if line.startswith("phase ")]
    assert phases and all("mismatches 0;" in line for line in phases)
    if args:
        assert [p.split(":")[0] for p in phases] == ["phase sharded"]


def test_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 2
    assert capsys.readouterr().out == ""


def test_fails_alone(tmp_path):
    """Copied into a directory without the rest of the repo it must fail
    and print no result line."""
    shutil.copy("chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
