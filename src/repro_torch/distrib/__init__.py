"""Fault tolerance and sharding of the port (``repro.distrib``):
resumable calibration, the elastic mesh and the calibration statistics'
placement on a mesh. Parameter placement (``param_specs``) waits for the
tensor-parallel slice (ROADMAP Queue 1 item 2b)."""
from repro_torch.distrib.fault import CalibrationCheckpointer, remesh
from repro_torch.distrib.sharding import CalibSharding, stats_specs

__all__ = ["CalibSharding", "CalibrationCheckpointer", "remesh",
           "stats_specs"]
