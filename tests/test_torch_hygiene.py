"""Import hygiene of the PyTorch port: nothing under ``src/repro_torch/``
nor ``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and
importing the serving and evaluation stacks leaves JAX unloaded."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(ln, m) for ln, m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule_itself():
    assert _forbidden("jax.numpy") and _forbidden("repro.serving")
    assert _forbidden("repro") and not _forbidden("repro_torch.serving")


def test_serving_import_leaves_jax_unloaded():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src")] +
                                        [p for p in sys.path if p])
    code = ("import sys, repro_torch.serving.scheduler, repro_torch.convert, "
            "repro_torch.configs.qwen3_14b, repro_torch.train, repro_torch.quant.ptq, "
            "repro_torch.data, repro_torch.core.outliers, repro_torch.optim, "
            "repro_torch.kernels.flash_attention, repro_torch.kernels.fake_quant, "
            "repro_torch.kernels.rg_lru, repro_torch.nn.recurrent, "
            "repro_torch.configs.recurrentgemma_9b; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
