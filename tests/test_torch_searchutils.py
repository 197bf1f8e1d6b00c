"""The port's candidate-list primitives against the JAX package's.

Inputs are built to tie: repeated ids, repeated keys, SENTINEL padding and
INF keys. Which of the tied entries survive a top-L cut is decided by the
sorts' stability, so the port must give identical ids, keys and flags, not
merely the same sets."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import searchutils as jsu
from repro_torch.core import searchutils as tsu


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is as fast, and the
    test workers sharing a few cores do not oversubscribe them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_constants_match():
    assert tsu.SENTINEL == int(jsu.SENTINEL)
    assert np.float32(tsu.INF) == np.float32(jsu.INF)


def _tied_inputs(rng, n, k_cols, f_cols):
    """ids drawn from a few values, a quarter SENTINEL; keys from a few
    levels, a quarter INF; random flags."""
    ids = rng.integers(0, max(2, n // 4), n).astype(np.int32)
    ids[rng.random(n) < 0.25] = tsu.SENTINEL
    keys = rng.integers(0, 4, (n, k_cols)).astype(np.float32)
    keys[rng.random((n, k_cols)) < 0.25] = np.float32(tsu.INF)
    flags = rng.random((n, f_cols)) < 0.5
    return ids, keys, flags


@pytest.mark.parametrize("n,L,k_cols,f_cols", [
    (16, 8, 1, 1), (40, 12, 2, 2), (64, 64, 1, 1), (100, 24, 2, 2),
    (7, 7, 2, 1),
])
def test_dedup_merge_topL_identical(n, L, k_cols, f_cols):
    rng = np.random.default_rng(n + L)
    rows = [_tied_inputs(rng, n, k_cols, f_cols) for _ in range(6)]
    ids, keys, flags = (np.stack([r[j] for r in rows]) for j in range(3))
    want = jax.jit(jax.vmap(functools.partial(jsu.dedup_merge_topL, L=L)))(
        jnp.asarray(ids), jnp.asarray(keys), jnp.asarray(flags))
    got = tsu.dedup_merge_topL(torch.as_tensor(ids.astype(np.int64)),
                               torch.as_tensor(keys), torch.as_tensor(flags),
                               L)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,w", [(16, 4), (40, 8), (64, 10), (9, 9)])
def test_top_w_unexpanded_identical(n, w):
    rng = np.random.default_rng(n * w)
    keys = rng.integers(0, 3, (5, n)).astype(np.float32)
    keys[rng.random((5, n)) < 0.3] = np.float32(tsu.INF)
    expanded = rng.random((5, n)) < 0.4
    valid = rng.random((5, n)) < 0.8
    w_dyn = rng.integers(1, w + 1, 5)
    got_idx, got_act = tsu.top_w_unexpanded(
        torch.as_tensor(keys), torch.as_tensor(expanded),
        torch.as_tensor(valid), w, w_dynamic=torch.as_tensor(w_dyn))
    idx, act = jax.jit(jax.vmap(
        lambda k, e, v, wd: jsu.top_w_unexpanded(k, e, v, w, w_dynamic=wd)))(
        jnp.asarray(keys), jnp.asarray(expanded), jnp.asarray(valid),
        jnp.asarray(w_dyn.astype(np.int32)))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got_act.numpy(), np.asarray(act))


def test_segmented_min_or_long_runs():
    """Runs longer than any shift still reduce exactly into their first
    element."""
    ids = np.sort(np.repeat(np.arange(5), [1, 7, 33, 2, 21])).astype(np.int32)
    rng = np.random.default_rng(3)
    keys = rng.normal(size=(len(ids), 2)).astype(np.float32)
    flags = rng.random((len(ids), 2)) < 0.1
    wk, wf = jax.jit(jsu._segmented_min_or)(jnp.asarray(ids),
                                            jnp.asarray(keys),
                                            jnp.asarray(flags))
    gk, gf = tsu._segmented_min_or(torch.as_tensor(ids[None].astype(np.int64)),
                                   torch.as_tensor(keys[None]),
                                   torch.as_tensor(flags[None]))
    np.testing.assert_array_equal(gk[0].numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gf[0].numpy(), np.asarray(wf))


def test_sq_dists_matches():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    X = rng.normal(size=(3, 11, 16)).astype(np.float32)
    want = np.asarray(jax.vmap(jsu.sq_dists)(jnp.asarray(q), jnp.asarray(X)))
    got = tsu.sq_dists(torch.as_tensor(q), torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
