"""The port stands alone: every module of ``scanpaths_tpu_torch`` and
``chip_smoke.py`` imports with ``jax`` and ``scanpaths_tpu`` made
unimportable, no source line of theirs imports either, and the port's
copies of the JAX package's numpy modules stay identical to them."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

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
    assert {"scanpaths_tpu_torch.ops.nw", "scanpaths_tpu_torch.cli.train",
            "scanpaths_tpu_torch.utils.checkpointing",
            "scanpaths_tpu_torch.native",
            "scanpaths_tpu_torch.train.mesh",
            "scanpaths_tpu_torch.train.tp_step"} <= set(mods)
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


COPIES = ("core/config.py", "core/grid.py", "data/transforms.py",
          "metrics/scanmatch.py", "metrics/vame.py", "metrics/multimatch.py",
          "metrics/evaluation.py", "utils/logger.py", "utils/recording.py",
          "data/prefetch.py", "data/packed_cache.py", "native/__init__.py",
          "native/sp_native.cpp", "data/preprocess.py", "cli/preprocess.py")


@pytest.mark.parametrize("path", COPIES)
def test_copied_module_is_identical_to_its_original(path):
    """The port's copies of the JAX package's host modules differ from
    the originals only in the note that names the original: a docstring
    paragraph (and, where that note ends the docstring, the line break
    before its closing quotes), or in the C++ source a comment paragraph.
    The originals are read, never written."""
    lead, sep = (r"\n//\n// ", r"\n// ") if path.endswith(".cpp") \
        else (r"\n\n", r"\n")
    note = re.compile(
        lead + r"The port's own copy of ``scanpaths_tpu/" + re.escape(path)
        + r"``" + sep + r"\(the port imports nothing of the JAX package\); "
        r"keep the two identical\.")
    copy, n = note.subn("", (PORT / path).read_text())
    assert n == 1, f"{path}: the copy's docstring note is missing"
    original = (REPO / "scanpaths_tpu" / path).read_text()
    assert copy.replace('\n"""', '"""') == original.replace('\n"""', '"""')


def test_no_source_line_imports_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|scanpaths_tpu)(\.|\s|$)")
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [f"{path.relative_to(REPO)}:{n}: {line.strip()}"
           for path in files
           for n, line in enumerate(path.read_text().splitlines(), 1)
           if pattern.match(line)]
    assert not bad, bad
