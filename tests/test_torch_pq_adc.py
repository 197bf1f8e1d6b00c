"""The port's `pq_adc` against the JAX package's.

On the CPU the port's wrappers take the plain version (`ref.pq_adc_ref`),
with the padding and the +inf guard of `kernels/pq_adc.py`. They are held
against the reference's Pallas `pq_adc` in interpret mode and its pure-jnp
`pq_adc_ref`, on the same numpy inputs, with the sweeps and tolerances of
tests/test_kernels.py and tests/test_fused_pipeline.py. The CUDA kernel is
held against the plain version on the card, in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.pq_adc import pq_adc as pallas_pq_adc
from repro.kernels.ref import pq_adc_ref as jax_pq_adc_ref
from repro_torch import kernels as ops
from repro_torch.core.pq import train_pq
from repro_torch.kernels import ref
from repro_torch.kernels.pq_adc import pq_adc

SWEEP = [(100, 8, 64), (512, 16, 128), (1000, 16, 512), (4096, 32, 512),
         (7, 16, 8)]


def _inputs(seed, n, m):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, m)).astype(np.uint8),
            (rng.normal(size=(m, 256)) ** 2).astype(np.float32))


@pytest.mark.parametrize("n,m,block", SWEEP)
def test_pq_adc_sweep_matches_reference(n, m, block):
    codes, lut = _inputs(n + m, n, m)
    jc, jl = jnp.asarray(codes), jnp.asarray(lut)
    want_pallas = np.asarray(pallas_pq_adc(jc, jl, block_n=block,
                                           interpret=True))
    want_ref = np.asarray(jax_pq_adc_ref(jc, jl))
    tc, tl = torch.as_tensor(codes), torch.as_tensor(lut)
    for got in (ref.pq_adc_ref(tc, tl), pq_adc(tc, tl, block_n=block),
                ops.pq_adc(tc, tl, block_n=block)):
        assert got.shape == (n,) and got.dtype == torch.float32
        for want in (want_pallas, want_ref):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("n,block", [(100, 64), (513, 512), (7, 8), (65, 64)])
def test_pq_adc_pad_tail_is_inf(n, block):
    codes, lut = _inputs(n, n, 16)
    want = np.asarray(pallas_pq_adc(jnp.asarray(codes), jnp.asarray(lut),
                                    block_n=block, interpret=True,
                                    keep_pad=True))
    got = pq_adc(torch.as_tensor(codes), torch.as_tensor(lut),
                 block_n=block, keep_pad=True).numpy()
    assert got.shape == want.shape and got.shape[0] % block == 0
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-5)
    assert np.all(np.isinf(got[n:])) and np.all(got[n:] > 0)
    np.testing.assert_array_equal(got[n:], want[n:])


def test_pq_adc_nvalid_guards_a_prepadded_buffer():
    """A caller that padded the codes itself names the true length: rows
    from `nvalid` on are +inf, as in the reference."""
    codes, lut = _inputs(11, 96, 8)
    want = np.asarray(pallas_pq_adc(jnp.asarray(codes), jnp.asarray(lut),
                                    block_n=32, interpret=True, nvalid=70))
    got = pq_adc(torch.as_tensor(codes), torch.as_tensor(lut), block_n=32,
                 nvalid=70).numpy()
    np.testing.assert_allclose(got[:70], want[:70], rtol=1e-5)
    assert np.all(np.isinf(got[70:])) and np.all(np.isinf(want[70:]))


@pytest.mark.parametrize("n", [100, 513, 700, 1025])
def test_pq_adc_bucketed_matches_reference(n):
    codes, lut = _inputs(5 + n, n, 8)
    want = np.asarray(jax_ops.pq_adc(jnp.asarray(codes), jnp.asarray(lut),
                                     block_n=256))
    got = ops.pq_adc(torch.as_tensor(codes), torch.as_tensor(lut),
                     block_n=256).numpy()
    assert got.shape == want.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_pq_adc_ref(
        jnp.asarray(codes), jnp.asarray(lut))), rtol=1e-5)


def test_pq_adc_bucketed_refuses_no_rows():
    """bucket_size(0) raises, in the port as in the reference."""
    with pytest.raises(ValueError, match="n >= 1"):
        ops.pq_adc(torch.zeros((0, 8), dtype=torch.uint8),
                   torch.ones((8, 256)))
    with pytest.raises(ValueError, match="n >= 1"):
        jax_ops.pq_adc(jnp.zeros((0, 8), jnp.uint8), jnp.ones((8, 256)))


def test_pq_adc_matches_host_adc_of_the_ports_pq():
    """The kernel's ADC equals PQ.adc on the port's own codebook (as
    tests/test_kernels.py holds the reference's)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(512, 64)).astype(np.float32)
    pq = train_pq(x, m=8, sample=512, iters=4, device="cpu")
    q = rng.normal(size=(64,)).astype(np.float32)
    ids = np.arange(100)
    got = ops.pq_adc(torch.as_tensor(pq.codes[ids]),
                     torch.as_tensor(pq.lut(q)), block_n=32).numpy()
    np.testing.assert_allclose(got, pq.adc(q, ids), rtol=1e-4)
