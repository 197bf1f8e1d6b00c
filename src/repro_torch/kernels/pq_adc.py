"""pq_adc: the ADC lookup-table scan of the memory-layout PQ filter (paper
§4.1.1), the port of src/repro/kernels/pq_adc.py.

codes (N, M) uint8 and lut (M, 256) f32 give (N,) f32 holding
sum_j lut[j, codes[i, j]]. As in the reference, N is padded up to a
multiple of `block_n`, and every row at or past `nvalid` (default N) is
+inf, so a caller that keeps the padded buffer cannot take a pad row for a
candidate. The pad rows stand for zero codes, as the reference's `jnp.pad`
makes them; they are padded by length and never materialised.

The padding and the guard are decided here, for both paths: a tensor on the
CPU takes the plain version (ref.pq_adc_ref), a CUDA tensor the kernel of
csrc/pq_adc.cu or a raise. On the TPU `block_n` was the grid's tile; here
it only sets the padded length.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (_check, _on_card, _raise_on, _stream,
                                         launches)
from repro_torch.kernels.ref import pq_adc_ref

MAX_M = 64            # csrc/pq_adc.cu holds the (M, 256) LUT in shared memory
MAX_ROWS = 2 ** 30    # and indexes rows with 32-bit ints


def _check_args(codes, lut) -> None:
    _check("codes", codes, (torch.uint8,), 2)
    _check("lut", lut, (torch.float32,), 2)
    m = codes.shape[1]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"pq_adc's kernel takes 1 to {MAX_M} subspaces, "
                         f"got M = {m}")
    if tuple(lut.shape) != (m, 256):
        raise ValueError(f"lut {tuple(lut.shape)} is not (M, 256) for "
                         f"{m} subspaces of 256 codes")


def launch_pq_adc(codes, lut, n_out: int, nvalid: int, out=None):
    """The pq_adc kernel on checked arguments, 0 <= nvalid <= n_out:
    (n_out,) f32, made here unless `out` is given."""
    n, m = codes.shape
    if out is None:
        out = torch.empty(n_out, dtype=torch.float32, device=codes.device)
    vec16 = m % 16 == 0 and codes.data_ptr() % 16 == 0
    fn = _build.library("pq_adc").pq_adc_f32
    _raise_on(fn(codes.data_ptr(), lut.data_ptr(), out.data_ptr(), n, nvalid,
                 n_out, m, int(vec16), _stream(codes)), "pq_adc")
    return out


def pq_adc_padded(codes, lut, n_out: int, nvalid: int):
    """(n_out,) f32: the ADC distance of each row of `codes`, the zero-code
    pad rows after them up to n_out (n_out >= N), and +inf from row
    `nvalid` on."""
    n = codes.shape[0]
    if n_out < n:
        raise ValueError(f"n_out={n_out} is shorter than the {n} codes")
    if not _on_card(codes, lut):
        pad = codes.new_zeros((n_out - n, codes.shape[1]))
        dists = pq_adc_ref(torch.cat([codes, pad]), lut)
        row = torch.arange(n_out)
        return torch.where(row < nvalid, dists, torch.inf)
    _check_args(codes, lut)
    if n_out >= MAX_ROWS:
        raise ValueError(f"pq_adc's kernel takes fewer than {MAX_ROWS} rows, "
                         f"got {n_out}")
    if n_out == 0:
        return torch.empty(0, dtype=torch.float32, device=codes.device)
    out = launch_pq_adc(codes, lut, n_out, min(max(nvalid, 0), n_out))
    launches["pq_adc"] += 1
    return out


def pq_adc(codes, lut, *, block_n: int = 512, keep_pad: bool = False,
           nvalid=None):
    """codes (N, M) uint8; lut (M, 256) f32 -> (N,) f32.

    `nvalid` (defaults to N) marks the true row count when the caller
    already padded `codes`: rows >= nvalid come back +inf. `keep_pad=True`
    returns the whole padded buffer (its tail +inf) instead of slicing."""
    n = codes.shape[0]
    out = pq_adc_padded(codes, lut, n + (-n) % block_n,
                        n if nvalid is None else int(nvalid))
    return out if keep_pad else out[:n]
