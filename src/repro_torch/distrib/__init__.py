"""Fault tolerance and sharding of the port (``repro.distrib``):
resumable calibration, the elastic mesh, the calibration statistics' and
the parameters' placement on a mesh (``stats_specs``, ``param_specs``,
``forward_specs``, ``shard_params``), and collectives through shared
memory for ranks of one host (``hostcoll``)."""
from repro_torch.distrib.fault import CalibrationCheckpointer, remesh
from repro_torch.distrib.sharding import (CalibSharding, batch_specs,
                                          forward_specs, param_specs,
                                          shard_params, stats_specs)

__all__ = ["CalibSharding", "CalibrationCheckpointer", "remesh",
           "stats_specs", "param_specs", "forward_specs", "shard_params",
           "batch_specs"]
