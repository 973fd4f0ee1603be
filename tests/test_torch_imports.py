"""The PyTorch/CUDA port stands alone: no file of ``paddle_tpu_torch/``,
and not ``chip_smoke.py``, imports JAX or anything of the JAX package
``paddle_tpu`` — checked statically over every import statement and
dynamically in a fresh interpreter. ``chip_smoke.py`` refuses to run
without a CUDA device or outside a checkout, printing no result."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod):
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import paddle_tpu_torch.serving, "
            "paddle_tpu_torch.kernels.flash, paddle_tpu_torch.jit, "
            "paddle_tpu_torch.nn, paddle_tpu_torch.optimizer, "
            "paddle_tpu_torch.models.llama, paddle_tpu_torch.flags, "
            "chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, env=_clean_env(),
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True,
                          env=dict(_clean_env(), CUDA_VISIBLE_DEVICES=""),
                          timeout=120)


def test_smoke_fails_without_a_card():
    r = _run_smoke(ROOT)
    assert r.returncode != 0 and r.stdout == ""


def test_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0 and r.stdout == ""
