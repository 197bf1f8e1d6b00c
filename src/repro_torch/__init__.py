"""repro_torch — the PyTorch/CUDA port of `repro` for one NVIDIA H100.

Same subpackages as `repro` (`core/`, `io/`, `kernels/`). It imports torch
and numpy, never jax and nothing of `repro`. Its entry points run on "cuda"
unless the caller passes `device="cpu"`.
"""
from repro_torch.core import (DATASET_NAMES, PRESETS, Dataset, DiskIndex,
                              QueryStats, SearchConfig, SSDModel, build_index,
                              get_preset, make_dataset, recall_at_k,
                              search_batched, summarize)

__all__ = ["DATASET_NAMES", "PRESETS", "Dataset", "DiskIndex", "QueryStats",
           "SSDModel", "SearchConfig", "build_index", "get_preset",
           "make_dataset", "recall_at_k", "search_batched", "summarize"]
