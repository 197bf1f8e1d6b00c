"""The port's checkpoints: the reference's file format, restored across
packages both ways.

- the twins of tests/test_training_checkpoint.py:22 and :36 (round trip
  with a bfloat16 leaf, keep-last-k pruning);
- `save` of (params, opt_state) writes the reference's keys, shapes and
  float32-for-bfloat16 dtypes (kimi's bfloat16 `m` included), and
  `background=True` writes the same file;
- a reference checkpoint of a tinyllama smoke run, restored by the port
  and resumed, continues the reference's loss trajectory at rtol 1e-4;
  the port's checkpoint, restored by the reference and resumed, continues
  the port's;
- `restore(shardings=...)` refuses a `Transformer` (its placement on a
  mesh waits for ROADMAP A11d) and leaves a leaf whose sharding is None
  as it restores without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rc
import repro.models as rmod
from repro.data.pipeline import DataConfig, TokenPipeline
from repro.launch.train import make_train_step as ref_make_train_step
from repro.training import checkpoint as rck
from repro.training import optim as roptim
from repro_torch.convert import params_from_reference
from repro_torch.launch.train import make_train_step
from repro_torch.models import init_params
from repro_torch.training import checkpoint as ck
from repro_torch.training import optim

SAVE_AT, STEPS = 3, 6
TRAJ_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_checkpoint_roundtrip(tmp_path):
    """The twin of tests/test_training_checkpoint.py:22."""
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)}}
    ck.save(tmp_path, 5, tree)
    ck.save(tmp_path, 10, {"a": tree["a"] * 2,
                           "b": {"c": tree["b"]["c"] * 2}})
    assert ck.latest_step(tmp_path) == 10
    restored, step = ck.restore(tmp_path, tree, device="cpu")
    assert step == 10
    np.testing.assert_allclose(restored["a"].numpy(), np.arange(10) * 2)
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert float(restored["b"]["c"].float().min()) == 2.0


def test_checkpoint_prune_keeps_k(tmp_path):
    """The twin of tests/test_training_checkpoint.py:36."""
    tree = {"a": torch.zeros(4)}
    for s in (1, 2, 3, 4, 5):
        ck.save(tmp_path, s, tree, keep=2)
    assert ck.latest_step(tmp_path) == 5
    restored, step = ck.restore(tmp_path, tree, step=4, device="cpu")
    assert step == 4
    with pytest.raises(FileNotFoundError):
        ck.restore(tmp_path, tree, step=1, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "manifest_00000004.json", "manifest_00000005.json",
        "step_00000004.proc0.npz", "step_00000005.proc0.npz"]


def test_restore_onto_a_mesh_waits_for_the_mesh_code(tmp_path):
    """Tensor leaves restore onto a mesh (tests/
    test_torch_parallel_collectives.py); a `Transformer`, which takes its
    values in place on one device, is refused a sharding until
    whole-model DTensors come (ROADMAP A11d). A sharding of None leaves a
    leaf as it restores without one."""
    cfg = rc.get_smoke_config("tinyllama-1.1b")
    model = init_params(cfg, torch.Generator().manual_seed(0),
                        dtype=torch.float32, device="cpu")
    ck.save(tmp_path, 1, {"model": model, "w": torch.arange(3.0)})
    with pytest.raises(ValueError, match="A11d"):
        ck.restore(tmp_path, {"model": model, "w": torch.zeros(3)},
                   shardings={"model": object(), "w": None}, device="cpu")
    tree, _ = ck.restore(tmp_path, {"w": torch.zeros(3)},
                         shardings={"w": None}, device="cpu")
    assert torch.equal(tree["w"], torch.arange(3.0))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "kimi-k2-1t-a32b"])
def test_save_writes_the_reference_keys(arch, tmp_path):
    cfg = rc.get_smoke_config(arch)
    params = rmod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    ref_opt = roptim.for_model(cfg)
    rck.save(tmp_path / "ref", 1, (params, roptim.init_state(params,
                                                             ref_opt)))
    model = params_from_reference(params, cfg, "cpu")
    state = optim.init_state(model, optim.for_model(cfg), device="cpu")
    ck.save(tmp_path / "port", 1, (model, state))
    ck.save(tmp_path / "bg", 1, (model, state), background=True).join()
    name = "step_00000001.proc0.npz"
    with np.load(tmp_path / "ref" / name) as want, \
            np.load(tmp_path / "port" / name) as got, \
            np.load(tmp_path / "bg" / name) as bg:
        assert set(got.files) == set(want.files)
        assert set(bg.files) == set(want.files)
        assert "1/step" in got.files and "0/stages/pos0/ln1/scale" in got.files
        for k in want.files:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, (k, got[k].dtype,
                                                   want[k].dtype)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(bg[k], want[k], err_msg=k)
    # and the reference restores the port's file into its own tree
    (rp, rs), step = rck.restore(tmp_path / "port",
                                 (params, roptim.init_state(params, ref_opt)))
    assert step == 1
    assert jax.tree.map(lambda x: x.dtype, rs) == jax.tree.map(
        lambda x: x.dtype, roptim.init_state(params, ref_opt))


def _batches(cfg):
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                    global_batch=2))
    return [pipe.batch(s)["tokens"] for s in range(STEPS)]


@pytest.fixture(scope="module")
def runs():
    """The tinyllama smoke config trained for STEPS steps by each package
    from the same parameters: (cfg, ref step fn, port step fn, ref losses,
    port losses)."""
    cfg = rc.get_smoke_config("tinyllama-1.1b")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=STEPS)
    ref_step = ref_make_train_step(cfg, roptim.for_model(cfg, **kw))
    port_step = make_train_step(cfg, optim.for_model(cfg, **kw))
    return cfg, kw, ref_step, port_step, _batches(cfg)


def _ref_run(runs, params, state, start, ckpt_dir=None):
    cfg, kw, ref_step, _, batches = runs
    err = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    losses = []
    for s in range(start, STEPS):
        params, state, err, m = ref_step(params, state, err,
                                         {"tokens": jnp.asarray(batches[s])})
        losses.append(float(m["loss"]))
        if ckpt_dir is not None and s + 1 == SAVE_AT:
            rck.save(ckpt_dir, SAVE_AT, (params, state))
    return losses


def _port_run(runs, model, state, start, ckpt_dir=None):
    cfg, kw, _, port_step, batches = runs
    losses = []
    for s in range(start, STEPS):
        model, state, _, m = port_step(model, state, None,
                                       {"tokens": torch.as_tensor(
                                           batches[s])})
        losses.append(float(m["loss"]))
        if ckpt_dir is not None and s + 1 == SAVE_AT:
            ck.save(ckpt_dir, SAVE_AT, (model, state))
    return losses


def test_reference_checkpoint_resumes_in_the_port(runs, tmp_path):
    cfg, kw = runs[0], runs[1]
    params = rmod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    ref_losses = _ref_run(runs, params, roptim.init_state(
        params, roptim.for_model(cfg, **kw)), 0, tmp_path)
    # the port's own parameters, overwritten by the restore
    model = init_params(cfg, torch.Generator().manual_seed(1),
                        dtype=torch.float32, device="cpu")
    state = optim.init_state(model, optim.for_model(cfg, **kw), device="cpu")
    (model, state), step = ck.restore(tmp_path, (model, state), device="cpu")
    assert step == SAVE_AT and int(state["step"]) == SAVE_AT
    losses = _port_run(runs, model, state, SAVE_AT)
    np.testing.assert_allclose(losses, ref_losses[SAVE_AT:], rtol=TRAJ_RTOL)


def test_port_checkpoint_resumes_in_the_reference(runs, tmp_path):
    cfg, kw = runs[0], runs[1]
    params = rmod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    model = params_from_reference(params, cfg, "cpu")
    state = optim.init_state(model, optim.for_model(cfg, **kw), device="cpu")
    port_losses = _port_run(runs, model, state, 0, tmp_path)
    target = rmod.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    (params, rstate), step = rck.restore(
        tmp_path, (target, roptim.init_state(target,
                                             roptim.for_model(cfg, **kw))))
    assert step == SAVE_AT and int(rstate["step"]) == SAVE_AT
    losses = _ref_run(runs, params, rstate, SAVE_AT)
    np.testing.assert_allclose(losses, port_losses[SAVE_AT:], rtol=TRAJ_RTOL)
