"""Continuous-batching serving of the port (``repro.serve``): the slot
engine, its KV and recurrent slot caches, the scheduler, the front-end
(bounded queue, deadlines, streaming, the asyncio skin), the prefix cache
and the replica router, and mesh sharding (``ServeSharding``,
``slot_specs``, ``device_bytes_estimate``: ``ServeEngine(sharding=)``)."""
from repro_torch.serve.cache import (RecurrentSlotCache, SlotCache,
                                     cache_bytes, cache_contract)
from repro_torch.serve.engine import (Completion, Request, ServeEngine,
                                      percentile_table, run_static_trace,
                                      synthetic_trace)
from repro_torch.serve.errors import ERRORS
from repro_torch.serve.frontend import (AsyncServeFrontend, Handle,
                                        ServeFrontend, frontend_table)
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.queue import Overloaded, Status
from repro_torch.serve.router import ReplicaRouter, ReplicaState
from repro_torch.serve.scheduler import AdmissionQueue, Scheduler
from repro_torch.serve.sharding import (ServeSharding, device_bytes_estimate,
                                        slot_specs)

__all__ = ["SlotCache", "RecurrentSlotCache", "cache_bytes",
           "cache_contract", "ERRORS", "Request", "Completion",
           "ServeEngine", "run_static_trace", "synthetic_trace",
           "percentile_table", "ServeFrontend", "AsyncServeFrontend",
           "Handle", "frontend_table", "PrefixCache", "AdmissionQueue",
           "Scheduler", "Overloaded", "Status", "ReplicaRouter",
           "ReplicaState", "ServeSharding", "slot_specs",
           "device_bytes_estimate"]
