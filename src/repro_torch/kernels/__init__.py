from repro_torch.kernels._launch import launches, reset_launches
from repro_torch.kernels.ops import (bucket_size, dedup_merge_topL,
                                     fused_page_rank, page_adc, page_scan,
                                     pq_adc)

__all__ = ["bucket_size", "dedup_merge_topL", "fused_page_rank", "launches",
           "page_adc", "page_scan", "pq_adc", "reset_launches"]
