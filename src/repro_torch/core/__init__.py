"""CORP core of the port (``repro.core``): units, statistics, calibration,
ranking, closed-form solves and the pruning pipeline."""
from repro_torch.core.calibrate import CalibrationEngine
from repro_torch.core.pruner import PruneConfig, corp_prune
from repro_torch.core.units import discover_units

__all__ = ["CalibrationEngine", "PruneConfig", "corp_prune",
           "discover_units"]
