"""Nothing a run loads is JAX, flax or the JAX package, the reference loads
nothing of the port, and a run without a card or without the program prints
no result.

Module names are compared by their top-level part as a whole word: the port
`kogarashi_tpu_torch` begins with the JAX package's name `kogarashi_tpu`.
"""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from zkbench import harness

ROOT = harness.ROOT
ZK = ROOT / "zkbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "kogarashi_tpu"}


def imported_tops(path: Path):
    """Top-level names of the absolute imports in a source file, and the
    relative imports' levels."""
    tree = ast.parse(path.read_text())
    tops, levels = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                levels.append(node.level)
            else:
                tops.add(node.module.split(".")[0])
    return tops, levels


@pytest.mark.parametrize("path", sorted(ZK.rglob("*.py")), ids=lambda p: str(p.relative_to(ZK)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops, _ = imported_tops(path)
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ZK / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ZK)))
def test_reference_imports_nothing_of_the_port(path):
    tops, levels = imported_tops(path)
    assert "kogarashi_tpu_torch" not in tops and not tops & FORBIDDEN
    assert tops <= {"__future__", "math", "hashlib", "operator", "numpy", "dataclasses", "typing", "abc"}, tops
    depth = len(path.relative_to(ZK / "reference").parts)  # a level may not climb out of reference/
    assert all(level <= depth for level in levels)


GUARD_SCRIPT = """
import json, sys, time, torch
torch.set_num_threads(2)
from zkbench import harness
import zkbench.run
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
for cell in bench["workloads"]:
    harness.driver_class(harness.cell_spec(bench, cell["name"])[2])
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.reader(m["name"])
res, _ = harness.run_cell(bench, "g16-2p20-msm", 7, 1e-3, False, "cpu", time.perf_counter(),
                          overrides={"constraints_log2": 6, "scalar_pool": 1, "warmup": 0}, log=lambda _: None)
import zkbench.reference.groth16, zkbench.reference.nova
print(json.dumps({"correct": res["correct"], "forbidden": harness.forbidden_modules(),
                  "port": "kogarashi_tpu_torch" in sys.modules}))
"""


def test_a_run_loads_no_forbidden_module():
    out = subprocess.run([sys.executable, "-c", GUARD_SCRIPT], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": [], "port": True}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kogarashi_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_modules() == ["jaxlib.xla"]


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and zkbench/, a run
    exits non-zero and prints nothing on stdout (here, without a card, for
    that reason first; on the card, because the port is missing)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ZK, tmp_path / "zkbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "zkbench.run", "--workload", "g16-2p20-msm", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode != 0 and out.stdout == ""
