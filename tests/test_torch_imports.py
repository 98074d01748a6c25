"""The port stands alone: every module of ``scanpaths_tpu_torch`` and
``chip_smoke.py`` imports with ``jax`` and ``scanpaths_tpu`` made
unimportable, and no source line of theirs imports either."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "scanpaths_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax():
    mods = _port_modules() + ["chip_smoke"]
    assert "scanpaths_tpu_torch.ops.nw" in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['scanpaths_tpu'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if sys.modules[m] is not "
            "None and (m.split('.')[0] in ('jax', 'flax', 'scanpaths_tpu')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_no_source_line_imports_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|scanpaths_tpu)(\.|\s|$)")
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [f"{path.relative_to(REPO)}:{n}: {line.strip()}"
           for path in files
           for n, line in enumerate(path.read_text().splitlines(), 1)
           if pattern.match(line)]
    assert not bad, bad
