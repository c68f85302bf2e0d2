"""Continuous-batching serving of the port (``repro.serve``): the slot
engine, its KV and recurrent slot caches and the scheduler. The front-end,
prefix cache, router and mesh sharding are not ported yet."""
from repro_torch.serve.cache import (RecurrentSlotCache, SlotCache,
                                     cache_bytes, cache_contract)
from repro_torch.serve.engine import (Completion, Request, ServeEngine,
                                      percentile_table, run_static_trace,
                                      synthetic_trace)
from repro_torch.serve.errors import ERRORS
from repro_torch.serve.scheduler import AdmissionQueue, Scheduler

__all__ = ["SlotCache", "RecurrentSlotCache", "cache_bytes",
           "cache_contract", "ERRORS", "Request", "Completion",
           "ServeEngine", "run_static_trace", "synthetic_trace",
           "percentile_table", "AdmissionQueue", "Scheduler"]
