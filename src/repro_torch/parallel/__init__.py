"""The mesh code of the port (src/repro/parallel/ on `torch.distributed`):
`ParallelContext` and the reference's `PartitionSpec` as DTensor placements
(`api`), the parameter, optimizer-state, batch and cache rules
(`sharding`), the transports of its collectives (`comm`) and the GPipe
schedule (`pipeline`). The submodules other than `api` are imported on
their own."""
from repro_torch.parallel.api import (NamedSharding, P, ParallelContext,
                                      PartitionSpec, placements)

__all__ = ["NamedSharding", "P", "ParallelContext", "PartitionSpec",
           "placements"]
