"""The port stands alone: no JAX, nothing of ``repro``, and no Triton.

A fresh interpreter with ``sys.modules["jax"] = None`` (so any ``import
jax`` raises) imports every module of ``repro_torch`` and ``chip_smoke``,
and a scan of the sources finds no import of the ``repro`` package.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "repro_torch.serving.engine" in mods
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'repro' or m.startswith(('repro.', 'jax.')))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def _imported_names(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_sources_never_import_repro_or_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("repro", "jax", "jaxlib"), \
                f"{path.relative_to(ROOT)} imports {name}"
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import repro.", "from repro.",
                                     "import repro ", "from repro ")), \
                f"{path.relative_to(ROOT)}: {s}"


def test_sources_never_import_triton():
    """Every kernel of the port is CUDA C++ built with nvcc: one build
    route, which needs no Triton."""
    for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert "triton" not in [n.split(".")[0]
                                for n in _imported_names(path)], \
            f"{path.relative_to(ROOT)} imports triton"
