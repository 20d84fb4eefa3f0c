"""``repro_torch`` stands alone: no JAX, nothing of ``repro``, no ml_dtypes.

Every module of the package is imported in a fresh interpreter in which
``jax`` and ``ml_dtypes`` cannot be imported, and every file of the package
and ``chip_smoke.py`` is checked statically for such imports.
"""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")

_IMPORT_ALL = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "ml_dtypes"):
    sys.modules[name] = None  # any import of these now raises ImportError
import repro_torch
mods = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
print(len(mods))
"""


def test_every_module_imports_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20  # every module was walked


_WORKER_CHAIN = """
import sys
import repro_torch.core.transport.multiproc
import repro_torch.core.codec  # noqa: F401
heavy = sorted(m for m in ("torch", "jax", "repro") if m in sys.modules)
assert not heavy, heavy
"""


def test_mp_worker_import_chain_has_no_torch():
    """An mp worker imports the module of its entry point and its parents
    (``repro_torch``, ``repro_torch.core``): none of them may pull in
    ``torch``, or every spawned worker pays for it."""
    r = subprocess.run([sys.executable, "-c", _WORKER_CHAIN],
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module or "")
    return out


def test_no_forbidden_imports_anywhere():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imported_roots(f):
            root = mod.split(".")[0]
            assert root not in FORBIDDEN, f"{f.relative_to(ROOT)} imports {mod}"
