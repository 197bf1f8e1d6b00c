"""The port's training launcher held against the reference's.

- `make_train_step` of both packages, from the same parameters (the
  reference's, carried across) on the same pipeline batches for 6 steps,
  gives the same losses, `grad_norm` and `lr` at rtol 1e-4: plain, with
  `accum=2` and with `compress=True`;
- the die-and-resume drill of tests/test_training_checkpoint.py:61, run
  in subprocesses as `main(sys.argv[1:], device="cpu")`: the killed run
  exits 42, the resumed one restarts at step 8 and ends on the
  uninterrupted run's last loss, bit for bit, since both halves run on
  one CPU;
- the twin of the straggler monitor's test (tests/test_training_checkpoint
  .py:123).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rc
import repro.models as rmod
from repro.data.pipeline import DataConfig, TokenPipeline
from repro.launch.train import make_train_step as ref_make_train_step
from repro.training import compression as rcomp
from repro.training import optim as roptim
from repro_torch.convert import params_from_reference
from repro_torch.launch.train import StragglerMonitor, make_train_step
from repro_torch.training import compression, optim

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STEPS, BATCH, SEQ = 6, 4, 32
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("compress,accum", [(False, 1), (False, 2),
                                            (True, 1)])
def test_train_step_trajectory_equals_the_reference(compress, accum):
    cfg = rc.get_smoke_config("tinyllama-1.1b")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)
    ref_opt, opt = roptim.for_model(cfg, **kw), optim.for_model(cfg, **kw)
    params = rmod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = params_from_reference(params, cfg, "cpu")
    ref_state, state = (roptim.init_state(params, ref_opt),
                        optim.init_state(model, opt, device="cpu"))
    ref_err = rcomp.init_error_state(params)
    err = compression.init_error_state(model, device="cpu")
    ref_step = ref_make_train_step(cfg, ref_opt, compress=compress,
                                   accum=accum)
    step = make_train_step(cfg, opt, compress=compress, accum=accum)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                    global_batch=BATCH))
    for s in range(STEPS):
        toks = pipe.batch(s)["tokens"]
        params, ref_state, ref_err, rm = ref_step(
            params, ref_state, ref_err, {"tokens": jnp.asarray(toks)})
        model, state, err, m = step(model, state, err,
                                    {"tokens": torch.as_tensor(toks)})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=RTOL,
                                       err_msg=f"step {s} {k}")
    if compress:
        assert float(sum(e.abs().sum() for e in
                         jax.tree.leaves(err, is_leaf=torch.is_tensor))) > 0


def test_train_die_and_resume_reproduces_trajectory(tmp_path):
    """The twin of tests/test_training_checkpoint.py:61-83."""
    env = dict(os.environ, PYTHONPATH=SRC)
    base = [sys.executable, "-c",
            "import sys; from repro_torch.launch.train import main; "
            "main(sys.argv[1:], device='cpu')",
            "--arch", "tinyllama-1.1b", "--smoke", "--steps", "24",
            "--batch", "2", "--seq", "32", "--ckpt-every", "8",
            "--log-every", "100"]
    m_all = tmp_path / "all.json"
    subprocess.run(base + ["--metrics-out", str(m_all)], env=env, check=True,
                   capture_output=True, timeout=300)
    ckd = tmp_path / "ck"
    r = subprocess.run(base + ["--ckpt-dir", str(ckd), "--die-at", "15"],
                       env=env, capture_output=True, timeout=300)
    assert r.returncode == 42, r.stderr  # simulated failure
    m_res = tmp_path / "res.json"
    subprocess.run(base + ["--ckpt-dir", str(ckd), "--resume",
                           "--metrics-out", str(m_res)], env=env, check=True,
                   capture_output=True, timeout=300)
    full = json.load(open(m_all))
    res = json.load(open(m_res))
    assert res["start"] == 8
    assert len(full["losses"]) == len(full["step_s"]) == 24
    np.testing.assert_allclose(res["losses"][-1], full["losses"][-1],
                               rtol=1e-4)
    assert res["losses"] == full["losses"][8:]       # one CPU: the same bits
    assert full["losses"][-1] < full["losses"][0]


def test_straggler_monitor_flags():
    """The twin of tests/test_training_checkpoint.py:123."""
    mon = StragglerMonitor(factor=3.0, warmup=3)
    for _ in range(10):
        mon.record(0.01)
    mon.record(0.2)
    assert mon.flagged == 1


def test_step_difference_allows_the_lr_only_where_a_code_flips():
    """`first_step` is deterministic on one device, and `step_difference`
    lets an element move by the lr only where its int8 code rounded the
    other way (its error-feedback residual moved by a quantization step)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import first_step, step_difference
    from repro_torch.models import reference_tree
    cfg = get_smoke_config("tinyllama-1.1b")
    a = first_step(cfg, "cpu", compress=True)
    b = first_step(cfg, "cpu", compress=True)
    r = step_difference(a, b, 1e-4, 1e-5)
    assert r["max_abs_param_diff"] == 0 and r["code_flips"] == 0
    assert r["elements"] == sum(p.numel() for p in a[0].parameters())
    lr = float(b[2]["lr"])
    wq = a[0].blocks[1].attn.wq
    e = a[1]["stages"]["pos0"]["attn"]["wq"]
    with torch.no_grad():
        wq[3, 5] += 0.9 * lr                        # a flipped element
        e[1, 3, 5] += 2 * float(e[1].abs().max())
    r = step_difference(a, b, 1e-4, 1e-5)
    assert r["code_flips"] == 1 and r["max_excess_over_tol"] <= 0
    with torch.no_grad():
        wq[3, 6] += 0.9 * lr                        # no flip: too far
    assert step_difference(a, b, 1e-4, 1e-5)["max_excess_over_tol"] > 0
    assert reference_tree(a[0])["stages"]["pos0"]["attn"]["wq"].shape == \
        e.shape
