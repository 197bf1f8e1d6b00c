"""The port's remat policies against the reference's, the dry run's
abstract inputs and parameters, and the data pipeline.

- `remat_policy="full"` and `"dots"` gradients equal the reference's
  `jax.checkpoint`ed ones (tinyllama: one block a stage; jamba: eight, with
  Mamba, attention and MoE) at the gradient tolerance;
- `input_specs` and `abstract_params` give the reference's shapes and
  dtypes for every full config and every mode, on the `meta` device: each
  per-layer tensor of the port is a slice of the reference's leaf stacked
  over `num_stages`;
- `data.pipeline` gives the reference's batches bit for bit, on one host
  and on two.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rc
import repro.models as rmod
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro_torch.convert import params_from_reference
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import abstract_params, input_specs
from repro_torch.models.transformer import (num_blocks, num_stages,
                                            reference_tree, stage_len)
from repro_torch.training.tree import tree_items
from test_torch_train_grads import (GRAD_ATOL, GRAD_RTOL, _ref_grad,
                                    assert_trees_close, batches, port_grad,
                                    port_paths, ref_paths)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-v0.1-52b"])
def test_remat_grads_equal_the_reference(arch, remat):
    cfg = rc.get_smoke_config(arch)
    params = rmod.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rb, pb = batches(cfg, seed=1)
    (rloss, _), rgrads = _ref_grad(params, cfg, rb, remat)
    (loss, _), grads = port_grad(params_from_reference(params, cfg, "cpu"),
                                 cfg, pb, remat)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    assert_trees_close(port_paths(grads), ref_paths(rgrads), GRAD_RTOL,
                       GRAD_ATOL)


def _dtype(t) -> str:
    return str(t.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", rc.ARCH_IDS)
def test_abstract_params_and_input_specs_equal_the_reference(arch):
    cfg = rc.get_config(arch)
    want = {"/".join(str(k.key) for k in kp): v for kp, v in
            jax.tree_util.tree_flatten_with_path(
                rmod.abstract_params(cfg))[0]}
    model = abstract_params(cfg)
    assert all(p.device.type == "meta" for p in model.parameters())
    assert len(model.blocks) == num_blocks(cfg)
    got = {"/".join(map(str, p)): leaf
           for p, leaf in tree_items(reference_tree(model))}
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        assert got[k].shape == tuple(w.shape), (k, got[k].shape, w.shape)
        assert _dtype(got[k]) == str(w.dtype), (k, got[k].dtype, w.dtype)
        if k.startswith("stages/"):
            assert len(got[k].params) == num_stages(cfg), k

    sl = stage_len(cfg)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = rc.get_shape(name)
        ref = rmod.model.input_specs(cfg, shape)
        port = input_specs(cfg, shape)
        assert set(port) == set(ref), (name, set(port) ^ set(ref))
        for k, v in port.items():
            if k == "cache":
                continue
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(ref[k].shape), (name, k)
            assert _dtype(v) == str(ref[k].dtype), (name, k)
        if "cache" not in port:
            continue
        assert len(port["cache"]) == num_blocks(cfg)
        for i, layer in enumerate(port["cache"]):
            stacked = ref["cache"][f"pos{i % sl}"]
            assert set(layer) == set(stacked), (i, set(layer), set(stacked))
            for kind, tensors in layer.items():
                assert set(tensors) == set(stacked[kind])
                for t_name, t in tensors.items():
                    w = stacked[kind][t_name]
                    assert t.device.type == "meta"
                    assert (num_stages(cfg),) + tuple(t.shape) == tuple(
                        w.shape), (name, i, kind, t_name)
                    assert _dtype(t) == str(w.dtype), (name, i, kind, t_name)


@pytest.mark.parametrize("hosts", [1, 2])
def test_data_pipeline_equals_the_reference(hosts):
    for seed, vocab in ((0, 100), (3, 32000)):
        for host in range(hosts):
            kw = dict(vocab_size=vocab, seq_len=16, global_batch=8,
                      seed=seed, num_hosts=hosts, host_index=host)
            ref = RefTokenPipeline(RefDataConfig(**kw))
            port = TokenPipeline(DataConfig(**kw))
            for step in (0, 7, 15):
                want, got = ref.batch(step), port.batch(step)
                assert got.keys() == want.keys()
                assert got["tokens"].dtype == want["tokens"].dtype
                assert got["tokens"].shape == (8 // hosts, 16)
                np.testing.assert_array_equal(got["tokens"], want["tokens"])
            it = iter(port)
            np.testing.assert_array_equal(next(it)["tokens"],
                                          ref.batch(0)["tokens"])
            np.testing.assert_array_equal(next(it)["tokens"],
                                          ref.batch(1)["tokens"])


def test_data_pipeline_deterministic_and_host_disjoint():
    """The twin of tests/test_training_checkpoint.py:48."""
    a = TokenPipeline(DataConfig(vocab_size=100, seq_len=16, global_batch=8))
    b = TokenPipeline(DataConfig(vocab_size=100, seq_len=16, global_batch=8))
    np.testing.assert_array_equal(a.batch(7)["tokens"], b.batch(7)["tokens"])
    h0 = TokenPipeline(DataConfig(vocab_size=100, seq_len=16, global_batch=8,
                                  num_hosts=2, host_index=0))
    h1 = TokenPipeline(DataConfig(vocab_size=100, seq_len=16, global_batch=8,
                                  num_hosts=2, host_index=1))
    assert not np.array_equal(h0.batch(0)["tokens"], h1.batch(0)["tokens"])
    assert h0.batch(0)["tokens"].shape == (4, 16)
