from repro_torch.io.page_store import (ArrayPageStore, CachedPageStore,
                                       PageStore, StoreCounters, build_store)

__all__ = ["ArrayPageStore", "CachedPageStore", "PageStore", "StoreCounters",
           "build_store"]
