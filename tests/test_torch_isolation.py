"""Import isolation of the PyTorch port: ceph_tpu_torch and chip_smoke.py
import no jax and nothing of ceph_tpu (the JAX reference package)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "ceph_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _module_name(path: Path) -> str:
    parts = list(path.relative_to(ROOT).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def _is_forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ceph_tpu")


def test_every_module_imports_with_jax_blocked():
    """Each port module imports with ``sys.modules["jax"] = None`` (so any
    jax import raises), and no ceph_tpu module gets loaded on the way."""
    names = [_module_name(p) for p in SOURCES if p.is_relative_to(PKG)]
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m == 'ceph_tpu' or m.startswith('ceph_tpu.'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert "ceph_tpu_torch.ops.gf_kernels" in names
    # the bench drivers, the oracle bridge and the smokes they feed
    assert {f"ceph_tpu_torch.{m}" for m in (
        "crush.oracle_bridge", "bench.timing", "bench.ec_bench", "bench.crush_bench",
        "bench.traffic", "bench.baseline", "qa.read_smoke", "qa.device_pool_smoke",
        "qa.qos_smoke", "qa.placement_smoke", "qa.health_smoke",
        "qa.accounting_smoke")} <= set(names)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_or_reference_import(path):
    """AST scan: no ``import jax``/``ceph_tpu...`` statement anywhere in the
    file (including lazy imports inside functions), and no relative import
    that climbs out of ceph_tpu_torch."""
    tree = ast.parse(path.read_text(), filename=str(path))
    depth = len(path.relative_to(ROOT).parts) - 1  # packages above the file
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _is_forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _is_forbidden(node.module):
                bad.append(node.module)
            if node.level > depth:
                bad.append("." * node.level + (node.module or ""))
    assert bad == []
