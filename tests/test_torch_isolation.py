"""The PyTorch port stands alone: importing every module of
``repro_torch`` (in a fresh interpreter) loads neither JAX nor any module
of the reference package ``repro``, and ``chip_smoke.py`` imports
neither. Only the tests import both packages."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _modules() -> list:
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return sorted(names)


def test_port_modules_found():
    mods = _modules()
    for want in ("repro_torch.core.f2", "repro_torch.core.bmmc",
                 "repro_torch.core.tiling", "repro_torch.guard.validate",
                 "repro_torch.obs.export", "repro_torch.kernels.ops",
                 "repro_torch.kernels.ref", "repro_torch.kernels.build",
                 "repro_torch.kernels.bmmc_permute",
                 "repro_torch.core.parm", "repro_torch.core.sort",
                 "repro_torch.combinators", "repro_torch.combinators.ir",
                 "repro_torch.combinators.vocab",
                 "repro_torch.combinators.optimize",
                 "repro_torch.combinators.execute",
                 "repro_torch.combinators.sort",
                 "repro_torch.combinators.fft",
                 "repro_torch.guard.runtime", "repro_torch.guard.inject",
                 "repro_torch.store", "repro_torch.store.codec",
                 "repro_torch.store.store", "repro_torch.resilience",
                 "repro_torch.resilience.breaker",
                 "repro_torch.resilience.policy",
                 "repro_torch.resilience.chaos", "repro_torch.configs",
                 "repro_torch.configs.base",
                 "repro_torch.configs.mistral_nemo_12b",
                 "repro_torch.models", "repro_torch.models.layers",
                 "repro_torch.models.permute", "repro_torch.models.attention",
                 "repro_torch.models.transformer",
                 "repro_torch.models.model", "repro_torch.models.convert",
                 "repro_torch.models.moe", "repro_torch.models.ssm",
                 "repro_torch.train", "repro_torch.train.serve",
                 "repro_torch.launch", "repro_torch.launch.serve",
                 "repro_torch.data", "repro_torch.data.pipeline",
                 "repro_torch.tree", "repro_torch.optim",
                 "repro_torch.optim.adamw", "repro_torch.optim.schedule",
                 "repro_torch.train.step", "repro_torch.checkpoint",
                 "repro_torch.checkpoint.ckpt", "repro_torch.launch.train",
                 "repro_torch.launch.hw", "repro_torch.launch.mesh",
                 "repro_torch.parallel", "repro_torch.parallel.sharding",
                 "repro_torch.models.moe_a2a",
                 "repro_torch.core.distributed",
                 "repro_torch.launch.op_analysis",
                 "repro_torch.launch.dryrun"):
        assert want in mods


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


@pytest.mark.parametrize("path", ["chip_smoke.py", "src/repro_torch"])
def test_port_sources_import_no_jax_and_no_reference(path):
    files = [ROOT / path] if path.endswith(".py") else sorted(
        (ROOT / path).rglob("*.py"))
    assert files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, name)
