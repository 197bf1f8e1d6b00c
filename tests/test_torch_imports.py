"""The port stands alone: it imports torch and never jax, nothing of the JAX
package, and no triton; and its entry points run on the card unless the
caller names another device."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def test_import_pulls_in_no_jax_repro_or_triton():
    code = ("import sys, repro_torch, repro_torch.convert, "
            "repro_torch.kernels._build, repro_torch.obs, "
            "repro_torch.mutation, repro_torch.serving; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("module", ["repro_torch.obs",
                                    "repro_torch.mutation",
                                    "repro_torch.serving"])
def test_subpackage_alone_pulls_in_no_jax_repro_or_triton(module):
    code = (f"import sys, {module}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        bad = {m for m in _imported_roots(path)
               if m in ("jax", "jaxlib", "repro", "triton")}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_entry_points_need_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch import build_index, make_dataset
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.engine import SearchConfig
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_dataset("deep-like", n=64, nq=4)
    ds = make_dataset("deep-like", n=64, nq=4, k_gt=10, device="cpu")
    assert isinstance(ds, Dataset) and ds.gt.shape == (4, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(ds, SearchConfig(), R=4, L_build=8)
