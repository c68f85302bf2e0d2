"""Fault tolerance and sharding of the port (``repro.distrib``):
resumable calibration, the restartable loop and the tolerant
accumulator, the elastic mesh, the calibration statistics' and
the parameters' placement on a mesh (``stats_specs``, ``param_specs``,
``forward_specs``, ``shard_params``), and collectives through shared
memory for ranks of one host (``hostcoll``)."""
from repro_torch.distrib.fault import (CalibrationCheckpointer,
                                      TolerantAccumulator, remesh,
                                      run_with_restarts)
from repro_torch.distrib.sharding import (CalibSharding, batch_specs,
                                          forward_specs, param_specs,
                                          shard_params, stats_specs)

__all__ = ["CalibSharding", "CalibrationCheckpointer", "remesh",
           "run_with_restarts", "TolerantAccumulator",
           "stats_specs", "param_specs", "forward_specs", "shard_params",
           "batch_specs"]
