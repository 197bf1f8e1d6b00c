from repro_torch.io.page_cache import (DYNAMIC_POLICIES, POLICIES,
                                       FIFOPageCache, LRUPageCache, PageCache,
                                       PartitionedPageCache,
                                       PrefetchingPageStore,
                                       SharedCachePageStore, TwoQPageCache,
                                       make_cache)
from repro_torch.io.page_store import (ArrayPageStore, BatchedPageStore,
                                       CachedPageStore, PageStore,
                                       StoreCounters, build_store,
                                       charge_inner_reads)
from repro_torch.io.sharded_store import (PLACEMENTS, Placement,
                                          ShardedPageStore, make_placement,
                                          make_shard_caches,
                                          profile_from_counters,
                                          profile_from_trace)

__all__ = ["ArrayPageStore", "BatchedPageStore", "CachedPageStore",
           "DYNAMIC_POLICIES", "FIFOPageCache", "LRUPageCache", "PLACEMENTS",
           "PageCache", "PageStore", "POLICIES", "PartitionedPageCache",
           "Placement", "PrefetchingPageStore", "ShardedPageStore",
           "SharedCachePageStore", "StoreCounters", "TwoQPageCache",
           "build_store", "charge_inner_reads", "make_cache",
           "make_placement", "make_shard_caches", "profile_from_counters",
           "profile_from_trace"]
