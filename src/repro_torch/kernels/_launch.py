"""What every kernel wrapper shares: the launch counts, the device
dispatch rule, the argument checks and the CUDA error check."""
from __future__ import annotations

import torch

# kernel launches of each wrapper, counted where the wrapper launches
launches = {"page_scan": 0, "page_adc": 0, "fused_page_rank": 0,
            "pq_adc": 0, "dedup_merge_topL": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_card(*tensors) -> bool:
    """True for CUDA tensors (all on one device), False for CPU tensors;
    raises on a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"the kernels take tensors all on the CPU or all "
                         f"on one CUDA device, got "
                         f"{sorted(str(t.device) for t in tensors)}")
    return True


def _check(name: str, t, dtypes, ndim: int) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")
