"""The port stands alone: no file of mpi_opt_tpu_torch/, and not
chip_smoke.py, imports JAX, flax, optax, orbax, the JAX package or
scikit-learn (the card's machine has none of them: the UCI tables ship
with the port)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mpi_opt_tpu", "sklearn"}
FILES = sorted((ROOT / "mpi_opt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_scan_covers_the_package():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", [
    "train/engine.py", "train/staging.py", "train/fused_asha.py", "ops/asha.py", "obs/memory.py",
    "obs/trace.py", "obs/report.py", "obs/bubbles.py", "algorithms/base.py", "algorithms/hyperband.py",
    "ops/tpe.py", "algorithms/bohb.py", "data/loaders.py", "workloads/tabular.py", "train/fused_tpe.py",
    "train/fused_bohb.py", "objectives/spec.py", "objectives/pareto.py", "objectives/__init__.py",
    "workloads/digits.py", "algorithms/__init__.py", "algorithms/random_search.py",
    "algorithms/asha.py", "algorithms/pbt.py", "algorithms/tpe.py", "backends/__init__.py",
    "backends/base.py", "backends/gpu.py", "ledger/cache.py", "driver.py", "utils/checkpoint.py",
    "ledger/warmstart.py", "ledger/report.py", "utils/integrity.py", "workloads/base.py",
    "workloads/synthetic.py", "workloads/chaos.py", "backends/cpu.py", "utils/profiling.py",
    "obs/diff.py", "obs/timeline.py", "parallel/__init__.py", "parallel/mesh.py", "parallel/coord.py",
    "launch.py", "health/watchdog.py", "service/__init__.py", "service/spool.py",
    "service/tenants.py", "service/leases.py", "service/programs.py", "service/scheduler.py",
    "service/client.py", "corpus/__init__.py", "corpus/match.py", "corpus/index.py",
    "corpus/resolve.py", "corpus/cli.py",
])
def test_wave_engine_modules_are_scanned(module):
    assert ROOT / "mpi_opt_tpu_torch" / module in FILES
