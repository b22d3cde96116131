"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared whole at
the top level: mpi_bicgstab_tpu_torch is the program, mpi_bicgstab_tpu
the JAX package."""
import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "mpi_bicgstab_tpu"}
PROGRAM = "mpi_bicgstab_tpu_torch"


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_of_the_benchmark_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert PROGRAM not in _imports(path), path


def test_the_guard_compares_whole_top_level_names():
    sys.path.insert(0, str(HERE))
    import run
    saved = dict(sys.modules)
    try:
        sys.modules["mpi_bicgstab_tpu_torch_x"] = sys
        sys.modules["jaxon.core"] = sys
        assert run.forbidden_modules() == sorted(
            {m.split(".")[0] for m in saved} & FORBIDDEN)
        sys.modules["mpi_bicgstab_tpu.ops"] = sys
        assert "mpi_bicgstab_tpu" in run.forbidden_modules()
    finally:
        for k in ("mpi_bicgstab_tpu_torch_x", "jaxon.core",
                  "mpi_bicgstab_tpu.ops"):
            sys.modules.pop(k, None)


def test_a_rehearsal_loads_neither():
    """A CPU rehearsal of a whole cell, traced stretch and check
    included, in a process of its own: its sys.modules afterwards."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(1)
from perfbench import spec
from perfbench.harness import CellRun
cell = spec.load_cell("hard-df32")
cell.traffic["trace_iters"] = 10
run = CellRun(cell, device="cpu", n=343)
run.setup(); run.use_seed(5)
run.window(0.05, trace="import-guard")
run.free_program(); run.check()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PROGRAM in tops
    assert not tops & FORBIDDEN
