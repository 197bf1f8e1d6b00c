"""Serving layer of the port: admission control, `AnnServer` (closed and
open loop) and the replica fleet `FleetServer`, ported from
src/repro/serving/; and the LM decode server `LMServer`
(repro_torch.serving.engine, imported on its own)."""
from repro_torch.serving.admission import (ADMISSION_POLICIES,
                                           AdmissionConfig,
                                           AdmissionController)
from repro_torch.serving.ann_server import (AnnServer, OpenLoopReport,
                                            ServerConfig, ServingReport)
from repro_torch.serving.fleet import (ROUTING_POLICIES, AutoscaleConfig,
                                       FleetConfig, FleetReport, FleetServer,
                                       MigrationConfig)

__all__ = ["ADMISSION_POLICIES", "AdmissionConfig", "AdmissionController",
           "AnnServer", "AutoscaleConfig", "FleetConfig", "FleetReport",
           "FleetServer", "MigrationConfig", "OpenLoopReport",
           "ROUTING_POLICIES", "ServerConfig", "ServingReport"]
