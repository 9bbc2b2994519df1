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
    scanned = {f.relative_to(PORT).parts[0] for f in files}
    assert {"nova", "utils", "ops", "pyref", "r1cs", "groth16", "curves", "signature", "pallet",
            "parallel"} <= scanned
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


_BLOCK = r"""
import importlib, pkgutil, random, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "kogarashi_tpu") or name.startswith(("jax.", "jaxlib", "kogarashi_tpu.")):
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, Block())
"""

_BLOCKED_RUN = _BLOCK + r"""
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


def _run_blocked(script: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_port_runs_with_jax_blocked():
    """Both JAX and the JAX package blocked: the port imports, and proves and
    verifies SquareChainCircuit(16) on the CPU."""
    assert "PROVED" in _run_blocked(_BLOCKED_RUN)


_BLOCKED_FOLD = _BLOCK + r"""
import torch
torch.set_num_threads(2)
from kogarashi_tpu_torch.nova.nifs import NifsProver, NifsVerifier
from kogarashi_tpu_torch.nova.pedersen import PedersenCommitment
from kogarashi_tpu_torch.nova.relaxed_r1cs import (R1csShape, RelaxedR1csInstance,
                                                   RelaxedR1csWitness, r1cs_instance_and_witness)
from kogarashi_tpu_torch.r1cs import GRUMPKIN_DRIVER, R1CS, FieldAssignment as FA

def cs_for(x_val):
    cs = R1CS(GRUMPKIN_DRIVER)
    x = FA.instance(cs, x_val)
    o = FA.instance(cs, (x_val**3 + x_val + 5) % GRUMPKIN_DRIVER.scalar.p)
    y = FA.mul(cs, FA.mul(cs, x, x), x)
    FA.enforce_eq(cs, FA.add(cs, y, x) + FA.constant(cs, 5), o)
    return cs

shape = R1csShape.from_r1cs(cs_for(4), "cpu")
ck = PedersenCommitment(GRUMPKIN_DRIVER.commit_curve, 2, random.Random(3), device="cpu")
x1, w1 = r1cs_instance_and_witness(cs_for(4), shape, ck)
i1 = RelaxedR1csInstance.from_r1cs_instance(GRUMPKIN_DRIVER, x1)
wt1 = RelaxedR1csWitness.from_r1cs_witness(shape, w1)
i2, wt2 = r1cs_instance_and_witness(cs_for(3), shape, ck)
fi, fw, ct = NifsProver(shape, ck).prove(i1, wt1, i2, wt2)
assert fi == NifsVerifier.verify(ct, i1, i2)
assert shape.is_sat_relaxed(fi, fw)
assert not any(k.split(".")[0] in ("jax", "kogarashi_tpu") for k in sys.modules)
print("FOLDED")
"""


_BLOCKED_VERIFY = _BLOCK + r"""
import torch
torch.set_num_threads(2)
from kogarashi_tpu_torch.pallet import NovaPallet
from kogarashi_tpu_torch.pyref import JUBJUB_SPEC
from kogarashi_tpu_torch.r1cs import GRUMPKIN_DRIVER
from kogarashi_tpu_torch.nova import RecursiveProof, R1csInstance, R1csWitness
from kogarashi_tpu_torch.nova import RelaxedR1csInstance, RelaxedR1csWitness
from kogarashi_tpu_torch.r1cs import BN254_DRIVER
from kogarashi_tpu_torch.signature import RedDSA, Signature, batch_verify
from kogarashi_tpu_torch.utils.serde import decode_recursive_proof, encode_recursive_proof

rng = random.Random(1)
pairs = [RedDSA().keygen(rng) for _ in range(3)]
msgs = [b"a", b"b", b"c"]
sigs = [sk.sign(m, rng) for (sk, _), m in zip(pairs, msgs)]
sigs[2] = Signature(sigs[2].r_bytes, (sigs[2].s + 1) % JUBJUB_SPEC.order)
assert batch_verify([v for _, v in pairs], msgs, sigs, device="cpu") == [True, True, False]

proof = RecursiveProof(
    i=1, z0_primary=[0], z0_secondary=[0], zi_primary=[1], zi_secondary=[2],
    u_single_secondary=R1csInstance.dummy(GRUMPKIN_DRIVER, 2), w_single_secondary=R1csWitness(w=[0]),
    u_range_primary=RelaxedR1csInstance.dummy(BN254_DRIVER, 2), w_range_primary=RelaxedR1csWitness.dummy(1, 1),
    u_range_secondary=RelaxedR1csInstance.dummy(GRUMPKIN_DRIVER, 2),
    w_range_secondary=RelaxedR1csWitness.dummy(1, 1))
data = encode_recursive_proof(proof)
assert encode_recursive_proof(decode_recursive_proof(data)) == data
pallet = NovaPallet()
assert not pallet.verify("alice", data, None)  # its state hashes do not match
assert pallet.events == [("InvalidProof", "alice")]
assert not any(k.split(".")[0] in ("jax", "kogarashi_tpu") for k in sys.modules)
print("VERIFIED")
"""


def test_batch_verify_and_pallet_with_jax_blocked():
    """Both JAX and the JAX package blocked: RedDSA batch verification of
    three signatures (one with S + 1) on the CPU, and the pallet decoding and
    rejecting a recursive proof."""
    assert "VERIFIED" in _run_blocked(_BLOCKED_VERIFY)


def test_nifs_fold_with_jax_blocked():
    """Both JAX and the JAX package blocked: one NIFS fold over the Grumpkin
    driver (a Grumpkin commitment key) on the CPU, checked by the verifier's
    fold and the relaxed shape."""
    assert "FOLDED" in _run_blocked(_BLOCKED_FOLD)


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
