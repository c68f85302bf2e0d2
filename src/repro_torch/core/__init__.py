"""CORP core of the port (``repro.core``): units, statistics, calibration,
ranking, closed-form solves and the pruning pipeline."""
from repro_torch.core.calibrate import CalibrationEngine, run_pass
from repro_torch.core.pruner import (PruneConfig, corp_prune,
                                     corp_prune_streamed)
from repro_torch.core.units import discover_units

__all__ = ["CalibrationEngine", "PruneConfig", "corp_prune",
           "corp_prune_streamed", "discover_units", "run_pass"]
