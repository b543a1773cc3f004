"""The port imports neither ``jax`` nor ``vit_tpu``: the machine with the
GPU has no JAX, and ``chip_smoke.py`` runs with the port alone."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "vit_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "vit_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_torch_port_sources_import_no_jax(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_torch_port_import_loads_no_jax():
    """Importing the port's entry points loads no JAX module."""
    code = (
        "import sys\n"
        "import vit_tpu_torch.models.vit, vit_tpu_torch.serving\n"
        "import vit_tpu_torch.ops.cuda.block, vit_tpu_torch.weights\n"
        "import vit_tpu_torch.quant, vit_tpu_torch.ops.cuda.quant\n"
        "import vit_tpu_torch.ops.cuda.stack\n"
        "import vit_tpu_torch.train, vit_tpu_torch.ops.autograd\n"
        "import vit_tpu_torch.ops.cuda.elementwise\n"
        "import vit_tpu_torch.ops.cuda.matmul3\n"
        "import vit_tpu_torch.parallel, vit_tpu_torch.parallel.tp\n"
        "import vit_tpu_torch.ops.cuda.patching, vit_tpu_torch.ops.debug\n"
        "import vit_tpu_torch.ops.cuda.debug\n"
        "import vit_tpu_torch.examples.minimal_matmul\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'vit_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_torch_forbidden_names_are_caught():
    """The scan tells the JAX package from the port by the module's first
    component."""
    assert _forbidden("vit_tpu.ops") and _forbidden("jax.numpy")
    assert not _forbidden("vit_tpu_torch.ops")
