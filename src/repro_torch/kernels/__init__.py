from repro_torch.kernels.ops import (bucket_size, fused_page_rank, launches,
                                    page_adc, page_scan, reset_launches)

__all__ = ["bucket_size", "fused_page_rank", "launches", "page_adc",
           "page_scan", "reset_launches"]
