"""The PyTorch port stands alone: importing every module of ``repro_torch``
loads neither JAX nor the JAX package ``repro``, and nothing builds or
touches a GPU at import time."""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.kernels.panel_gemm" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or\n"
        "             n.startswith('jax.') or n == 'repro' or\n"
        "             n.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|"
                        r"from\s+(jax|repro)\b(?!_torch))", re.M)


@pytest.mark.parametrize("name", [m for m in _modules()])
def test_module_source_names_no_jax_or_repro(name):
    path = SRC.joinpath(*name.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    assert not _FORBIDDEN.findall(path.read_text()), name


def test_chip_smoke_imports_nothing_of_jax():
    text = (SRC.parent / "chip_smoke.py").read_text()
    assert not _FORBIDDEN.findall(text)
