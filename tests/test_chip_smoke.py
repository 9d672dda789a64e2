"""chip_smoke.py refuses to run without a GPU: it exits non-zero and never
prints its result line, from the repo and from a directory holding the
script alone."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "script_alone"])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        cwd = tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr
