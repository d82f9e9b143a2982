"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, ``examples/quickstart_torch.py``,
``examples/serve_decode_torch.py``, ``tools/torch_obs_report.py`` or
``tools/torch_check_contracts.py``, imports JAX or anything of the JAX
package ``repro`` (the quickstart's run is checked in
tests/test_torch_paper.py, the serving example's and the report CLI's in
tests/test_torch_obs.py, the lint CLI's in tests/test_torch_contracts.py).

Checked twice: by importing every module in a fresh interpreter and looking
at ``sys.modules``, and by an AST scan of the sources (which also catches an
import inside a function that the first check never runs).
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    import repro_torch

    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    for m in ("repro_torch.kernels.table_pack_lookup", "repro_torch.core.range_reduce",
              "repro_torch.approx.range_fold", "repro_torch.kernels.routed_pack_lookup",
              "repro_torch.core.bram", "repro_torch.core.stats",
              "repro_torch.core.attn_error", "repro_torch.configs.tabla_paper",
              "repro_torch.launch.paper", "repro_torch.configs.deepseek_moe_16b",
              "repro_torch.configs.qwen3_moe_235b_a22b", "repro_torch.models.ssm",
              "repro_torch.models.xlstm", "repro_torch.configs.zamba2_1_2b",
              "repro_torch.configs.xlstm_125m", "repro_torch.configs.whisper_small",
              "repro_torch.configs.internvl2_1b", "repro_torch.obs.report",
              "repro_torch.parallel", "repro_torch.parallel.sharding",
              "repro_torch.parallel.params", "repro_torch.parallel.cache_specs",
              "repro_torch.launch.mesh", "repro_torch.kernels.ops",
              "repro_torch.analysis.contracts", "repro_torch.analysis.graph_lint"):
        assert m in mods, m
    code = (
        "import importlib, json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "examples" / "quickstart_torch.py",
                                         ROOT / "examples" / "serve_decode_torch.py",
                                         ROOT / "tools" / "torch_obs_report.py",
                                         ROOT / "tools" / "torch_check_contracts.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_repro_import(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert bad == [], f"{path}: forbidden imports {bad}"
