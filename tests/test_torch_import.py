"""aiocluster_torch stands alone: importing it (and every submodule) loads
neither JAX, flax nor any module of the reference package, and no source
file of the port names them in an import (nor ``ml_dtypes``, in the
twin, the host simulator and their copies of the reference's modules:
bfloat16 travels there as its 16-bit words)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "aiocluster_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "aiocluster_tpu")
BITS_ONLY = ["aiocluster_torch/twin/__init__.py", "aiocluster_torch/twin/replay.py",
             "aiocluster_torch/twin/calibrate.py", "aiocluster_torch/twin/drift.py",
             "aiocluster_torch/twin/autotune.py", "aiocluster_torch/sim/hostsim.py",
             "aiocluster_torch/utils/cbuild.py", "aiocluster_torch/core/config.py",
             "aiocluster_torch/core/identity.py"]


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_loads_no_jax_or_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported(path: str) -> list[str]:
    tree = ast.parse((ROOT / path).read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


@pytest.mark.parametrize("path", BITS_ONLY)
def test_twin_and_host_modules_import_no_ml_dtypes(path):
    assert not [m for m in _imported(path) if m.split(".")[0] == "ml_dtypes"], path


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_source_imports_no_jax_or_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_every_slice_module_is_covered():
    """The modules each slice added are among those imported above, the
    CLI, the planner, the twin and the host simulator included."""
    mods = set(_port_modules())
    for m in ("aiocluster_torch.__main__", "aiocluster_torch.parallel.multihost",
              "aiocluster_torch.sim.memory", "aiocluster_torch.sim.bytes",
              "aiocluster_torch.obs.expo", "aiocluster_torch.obs.profiling",
              "aiocluster_torch.twin", "aiocluster_torch.twin.replay",
              "aiocluster_torch.twin.calibrate", "aiocluster_torch.twin.drift",
              "aiocluster_torch.twin.autotune", "aiocluster_torch.core.config",
              "aiocluster_torch.core.identity", "aiocluster_torch.utils.cbuild",
              "aiocluster_torch.sim.hostsim"):
        assert m in mods, m
