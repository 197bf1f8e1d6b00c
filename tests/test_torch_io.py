"""The port's page stores against the JAX package's: the same sequence of
fetches, charges, writes and search bookings moves the same counters, and
`kernel_arrays()` hands out the layout as tensors on the store's device."""
import numpy as np
import pytest
import torch

from repro.core.pages import build_layout as jax_layout
from repro.io.page_store import build_store as jax_store
from repro_torch import sanitize
from repro_torch.core.pages import build_layout
from repro_torch.io import build_store


@pytest.fixture(scope="module")
def layouts():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 16)).astype(np.float32)
    g = rng.integers(-1, 200, (200, 8)).astype(np.int32)
    cached = np.zeros(200, bool)
    cached[rng.choice(200, 20, replace=False)] = True
    return (jax_layout(x, g, page_bytes=512), build_layout(x, g,
                                                           page_bytes=512),
            cached)


def _drive(store):
    store.fetch(np.array([0, 3, 3]))
    store.fetch(np.array([1, 2, 4]), vids=np.array([5, 9, 17]))
    store.charge(np.array([5, 6]))
    store.note_write([2, 7])
    store.note_write(kind="journal", count=3)

    class Stats:
        page_reads = np.array([4.0, 2.0])
        cache_hits = np.array([1.0, 0.0])
        n_read_records = np.array([12.0, 6.0])
    store.note_kernel_io(Stats)
    out = [store.counters.as_dict()]
    if hasattr(store, "inner"):
        out.append(store.inner.counters.as_dict())
    return out


@pytest.mark.parametrize("with_cache", [False, True])
def test_counters_move_as_the_reference(layouts, with_cache):
    jl, tl, cached = layouts
    mask = cached if with_cache else None
    ref = jax_store(jl, cached_vertices=mask)
    port = build_store(tl, cached_vertices=mask, device="cpu")
    assert type(port).__name__ == type(ref).__name__
    assert _drive(port) == _drive(ref)
    np.testing.assert_array_equal(port.vertex_cache_mask(),
                                  ref.vertex_cache_mask())
    with pytest.raises(IndexError):
        port.fetch(np.array([tl.num_pages]))


def test_kernel_arrays_on_the_store_device(layouts):
    _, tl, cached = layouts
    store = build_store(tl, cached_vertices=cached, device="cpu")
    vids, vecs, nbrs, v2p, v2s = store.kernel_arrays()
    assert store.kernel_arrays()[1] is vecs          # built once
    assert vecs.dtype == torch.float32 and vids.dtype == torch.int64
    for t, a in ((vids, tl.page_vids), (vecs, tl.page_vecs),
                 (nbrs, tl.page_nbrs), (v2p, tl.vid2page),
                 (v2s, tl.vid2slot)):
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), a)


def test_sanitizer_catches_a_counter_moving_backward(layouts, monkeypatch):
    _, tl, _ = layouts
    store = build_store(tl, device="cpu")
    store.fetch(np.array([1]))
    monkeypatch.setattr(sanitize, "_ENABLED", True)
    with pytest.raises(sanitize.SanitizeError, match="moved backward"):
        store.counters.pages_fetched -= 1
    store.counters.reset()
    assert store.counters.pages_fetched == 0
