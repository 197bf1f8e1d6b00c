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
            "repro_torch.mutation, repro_torch.serving, "
            "repro_torch.serving.fleet, repro_torch.serving.engine, "
            "repro_torch.configs, repro_torch.models, "
            "repro_torch.launch.serve, repro_torch.data, "
            "repro_torch.training.optim, repro_torch.training.accumulate, "
            "repro_torch.training.compression, "
            "repro_torch.training.checkpoint, repro_torch.launch.train, "
            "repro_torch.parallel, repro_torch.parallel.sharding, "
            "repro_torch.parallel.pipeline, repro_torch.parallel.comm, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.parallel.hloanalysis, "
            "repro_torch.parallel.opcount; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("module", ["repro_torch.obs",
                                    "repro_torch.mutation",
                                    "repro_torch.serving",
                                    "repro_torch.serving.fleet",
                                    "repro_torch.serving.engine",
                                    "repro_torch.configs",
                                    "repro_torch.models",
                                    "repro_torch.launch",
                                    "repro_torch.launch.serve",
                                    "repro_torch.data",
                                    "repro_torch.training",
                                    "repro_torch.launch.train",
                                    "repro_torch.parallel",
                                    "repro_torch.parallel.sharding",
                                    "repro_torch.parallel.pipeline",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.parallel.hloanalysis",
                                    "repro_torch.parallel.opcount"])
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


def test_lm_entry_points_need_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params
    cfg = get_smoke_config("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_reference({}, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="generator is on cpu"):
        init_params(cfg, torch.Generator().manual_seed(0), device="meta")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    assert params.device.type == "cpu"
    assert params.lm_head.dtype == torch.bfloat16      # param_dtype
    assert len(init_cache(cfg, 1, 4, device="cpu")) == cfg.num_layers


def test_training_entry_points_need_the_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train
    from repro_torch.models import init_params
    from repro_torch.training import checkpoint, compression, optim
    cfg = get_smoke_config("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    opt = optim.for_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        optim.init_state(params, opt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compression.init_error_state(params)
    state = optim.init_state(params, opt, device="cpu")
    assert state["step"].device.type == "cpu"
    checkpoint.save(tmp_path, 1, (params, state))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.restore(tmp_path, (params, state))
    with pytest.raises(ValueError, match="asked for on meta"):
        optim.init_state(params, opt, device="meta")
    with pytest.raises(ValueError, match="asked for on meta"):
        checkpoint.restore(tmp_path, (params, state), device="meta")
    (p2, s2), step = checkpoint.restore(tmp_path, (params, state),
                                        device="cpu")
    assert step == 1 and p2 is params and s2["step"].device.type == "cpu"
    assert train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq",
                       "16"], device="cpu")[-1] > 0
