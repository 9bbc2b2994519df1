"""Guards on the port's boundaries: it imports nothing of JAX or of the JAX
package (its target machine has no JAX, and the port keeps its own copies),
it runs with both blocked, its entry points run on the card unless told
otherwise, and chip_smoke.py refuses to run without a GPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "kogarashi_tpu_torch"
# modules of the JAX package the port may import: none
ALLOWED = set()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            if node.module == "kogarashi_tpu":
                yield from (f"kogarashi_tpu.{a.name}" for a in node.names)


def test_port_imports_no_jax():
    # _build/ holds build outputs, not sources
    files = sorted(f for f in PORT.rglob("*.py") if "_build" not in f.relative_to(PORT).parts)
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")
            assert top[0] not in ("jax", "jaxlib"), (f, mod)
            if top[0] == "kogarashi_tpu":
                assert len(top) > 1 and top[1] in ALLOWED, (f, mod)


def test_chip_smoke_imports_only_the_port():
    for mod in _imports(ROOT / "chip_smoke.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "kogarashi_tpu"), mod


def test_card_tests_import_only_the_port():
    for mod in _imports(ROOT / "tests" / "test_torch_cuda.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "kogarashi_tpu"), mod


_BLOCKED_RUN = r"""
import importlib, pkgutil, random, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "kogarashi_tpu") or name.startswith(("jax.", "jaxlib", "kogarashi_tpu.")):
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, Block())
import kogarashi_tpu_torch
for m in pkgutil.walk_packages(kogarashi_tpu_torch.__path__, "kogarashi_tpu_torch."):
    importlib.import_module(m.name)
from kogarashi_tpu_torch.groth16 import SquareChainCircuit, setup

circuit = SquareChainCircuit(16)
cs = circuit.build()
prover, verifier = setup(circuit, random.Random(1), device="cpu")
proof = prover.create_proof(circuit, random.Random(2))
assert verifier.verify(proof, cs.x[1:])
assert not verifier.verify(proof, [cs.x[1], cs.x[2] + 1])
assert not any(k.split(".")[0] in ("jax", "kogarashi_tpu") for k in sys.modules)
print("PROVED")
"""


def test_port_runs_with_jax_blocked():
    """Both JAX and the JAX package blocked: the port imports, and proves and
    verifies SquareChainCircuit(16) on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PROVED" in res.stdout


def test_chip_smoke_fails_without_gpu(tmp_path):
    """Here there is no CUDA device: the script exits non-zero and prints no
    result; alone in a directory it fails too."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
