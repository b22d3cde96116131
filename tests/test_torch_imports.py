"""The port stands alone: no module of mpi_bicgstab_tpu_torch, nor
chip_smoke.py, imports JAX or the JAX package (matched on the exact
top-level module name: `mpi_bicgstab_tpu_torch` itself starts with the
string `mpi_bicgstab_tpu`)."""
import ast
from pathlib import Path

import jax  # noqa: F401  (the test files import both packages)
import pytest
import torch

import mpi_bicgstab_tpu  # noqa: F401
import mpi_bicgstab_tpu_torch

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "mpi_bicgstab_tpu"}
PORT_FILES = sorted(Path(mpi_bicgstab_tpu_torch.__file__).parent.rglob(
    "*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and getattr(node.func, "attr",
                            getattr(node.func, "id", "")) in (
                                "import_module", "__import__"):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scan_sees_every_module_and_tells_the_names_apart():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for must in ("chip_smoke.py", "mpi_bicgstab_tpu_torch/api.py",
                 "mpi_bicgstab_tpu_torch/ops/cuda_fused_classic.py",
                 "mpi_bicgstab_tpu_torch/ops/cuda_fused_classic_df.py",
                 "mpi_bicgstab_tpu_torch/ops/cuda_fused_ca_df.py",
                 "mpi_bicgstab_tpu_torch/ops/cuda_fused_pipe_df.py",
                 "mpi_bicgstab_tpu_torch/ops/cuda_batched_spmv.py",
                 "mpi_bicgstab_tpu_torch/ops/cuda_fused_batched.py",
                 "mpi_bicgstab_tpu_torch/solvers/batched_fused.py",
                 "mpi_bicgstab_tpu_torch/ops/cheby.py",
                 "mpi_bicgstab_tpu_torch/ops/cuda_cheby.py",
                 "mpi_bicgstab_tpu_torch/ops/cuda_pipe_df_bodies.py",
                 "mpi_bicgstab_tpu_torch/ops/window_ell.py",
                 "mpi_bicgstab_tpu_torch/ops/window_spmv.py",
                 "mpi_bicgstab_tpu_torch/ops/cuda_window_spmv.py",
                 "mpi_bicgstab_tpu_torch/ops/butterfly.py",
                 "mpi_bicgstab_tpu_torch/ops/butterfly_spmv.py",
                 "mpi_bicgstab_tpu_torch/ops/cuda_butterfly.py",
                 "mpi_bicgstab_tpu_torch/ops/native_route.py",
                 "mpi_bicgstab_tpu_torch/ops/reorder.py",
                 "mpi_bicgstab_tpu_torch/ops/scale.py",
                 "mpi_bicgstab_tpu_torch/ops/precision.py"):
        assert must in names
    ok = ast.parse("import mpi_bicgstab_tpu_torch.api\n"
                   "from mpi_bicgstab_tpu_torch.ops import dia\n")
    assert not [m for m in _imported_modules(ok)
                if m.split(".")[0] in FORBIDDEN]
    bad = ast.parse("from mpi_bicgstab_tpu.ops import dia\nimport jax.numpy\n"
                    "importlib.import_module('jax')\n")
    assert [m.split(".")[0] for m in _imported_modules(bad)] == [
        "mpi_bicgstab_tpu", "jax", "jax"]


def test_package_exports_both_configs():
    """The JAX package's top level exports SolverConfig and ShiftedConfig;
    so does the port's."""
    from mpi_bicgstab_tpu import ShiftedConfig as JShifted
    from mpi_bicgstab_tpu_torch import ShiftedConfig, SolverConfig
    assert ShiftedConfig().tol == JShifted().tol
    assert SolverConfig is mpi_bicgstab_tpu_torch.utils.config.SolverConfig


def test_new_modules_import_without_jax():
    """Importing the windowed-ELL, reorder and scale modules and the CLI
    in a fresh interpreter leaves JAX and the JAX package out of
    sys.modules."""
    import subprocess
    import sys
    mods = ("mpi_bicgstab_tpu_torch.ops.window_ell",
            "mpi_bicgstab_tpu_torch.ops.window_spmv",
            "mpi_bicgstab_tpu_torch.ops.cuda_window_spmv",
            "mpi_bicgstab_tpu_torch.ops.reorder",
            "mpi_bicgstab_tpu_torch.ops.scale",
            "mpi_bicgstab_tpu_torch.cli")
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(sorted(FORBIDDEN)) + ")\nprint(bad)\n"
            + "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
