"""Fault tolerance of the port (``repro.distrib``): resumable calibration.
Sharding and the mesh are not ported (ROADMAP Queue 1 item 2)."""
from repro_torch.distrib.fault import CalibrationCheckpointer

__all__ = ["CalibrationCheckpointer"]
