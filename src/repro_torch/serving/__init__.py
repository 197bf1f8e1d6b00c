"""Serving layer of the port: admission control and `AnnServer` (closed
and open loop), ported from src/repro/serving/. The reference's replica
fleet (`FleetServer`) is not part of the port yet."""
from repro_torch.serving.admission import (ADMISSION_POLICIES,
                                           AdmissionConfig,
                                           AdmissionController)
from repro_torch.serving.ann_server import (AnnServer, OpenLoopReport,
                                            ServerConfig, ServingReport)

__all__ = ["ADMISSION_POLICIES", "AdmissionConfig", "AdmissionController",
           "AnnServer", "OpenLoopReport", "ServerConfig", "ServingReport"]
