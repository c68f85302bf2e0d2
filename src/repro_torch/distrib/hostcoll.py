"""Collectives of ranks that share one host, through a shared file mapping.

    hc = HostCollectives.for_group(ranks, index, control)   # every rank
    y = hc.all_reduce(x)            # the ranks' x summed, on x's device
    z = hc.all_gather(x, dim=-1)    # the ranks' x concatenated

Each rank has a slot in two alternating buffers of a file mapped by every
rank of the group (a file in the temporary directory, removed once all have
mapped it). A collective copies the rank's tensor to the host, writes its
bytes into the rank's slot, raises the rank's sequence number and polls
until every rank's has reached the collective's (briefly, then sleeping
between polls); then each rank reads all
slots: the sum in rank order (fp32, so every rank computes the same bits)
or the concatenation. A rank can run one collective ahead of the slowest:
the other buffer is the one it writes. A message longer than a slot goes
in slot-sized chunks, one sequence number each.

It exists because a process-group collective costs milliseconds between
ranks that share one card (gloo's ring hops through the host's TCP stack;
NCCL takes one rank a card), where this costs the device copies and a
spin. It relies on x86-64's store order (a rank's slot bytes are visible
before its sequence number) and refuses other hosts. A sharded engine
takes it where its ranks share cards (``serve.sharding.shares_card``). A
rank that waits longer than ``TIMEOUT_S`` for the others raises.
"""
from __future__ import annotations

import mmap
import os
import platform
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

SLOT_BYTES = 1 << 22    # a rank's slot in a buffer
SPINS = 256             # polls of the sequence numbers before a wait sleeps
TIMEOUT_S = 600.0       # a wait this long means a rank is gone


class HostCollectives:
    """The shared-memory collectives of one group of ``size`` ranks on a
    host; ``index`` is this rank's place in the group."""

    def __init__(self, path: str, size: int, index: int):
        self.size, self.index, self.n = size, index, 0
        self._pinned = {}       # "in" / "out" -> page-locked staging bytes
        nbytes = 8 * size + 2 * size * SLOT_BYTES
        with open(path, "r+b") as f:
            self._map = mmap.mmap(f.fileno(), nbytes)
        self.seq = np.frombuffer(self._map, np.int64, size, 0)
        self.slots = np.frombuffer(self._map, np.uint8, 2 * size * SLOT_BYTES,
                                   8 * size).reshape(2, size, SLOT_BYTES)

    @classmethod
    def for_group(cls, ranks, index: int, control):
        """Collective over ``control`` (a host group of every rank that
        builds one): each group's first rank creates its file, every rank
        maps its group's, and the files are removed once all are mapped.
        ``ranks``: the global ranks of this rank's group."""
        if platform.machine() not in ("x86_64", "AMD64"):
            raise RuntimeError(f"host collectives rely on x86-64's store "
                               f"order; this host is {platform.machine()}")
        path = None
        if index == 0:
            fd, path = tempfile.mkstemp(prefix="repro_torch_tp_")
            os.ftruncate(fd, 8 * len(ranks) + 2 * len(ranks) * SLOT_BYTES)
            os.close(fd)
        paths = [None] * dist.get_world_size(control)
        dist.all_gather_object(paths, (ranks[0], path), group=control)
        mine = dict(p for p in paths if p[1] is not None)[ranks[0]]
        out = cls(mine, len(ranks), index)
        dist.barrier(group=control)
        if index == 0:
            os.remove(mine)
        return out

    def _exchange(self, chunk: np.ndarray) -> np.ndarray:
        """Every rank's ``chunk`` (bytes, at most a slot): (size, n)."""
        self.n += 1
        buf = self.slots[self.n % 2]
        k = chunk.size
        buf[self.index, :k] = chunk
        self.seq[self.index] = self.n
        spins, t0 = 0, None
        while self.seq.min() < self.n:
            # a rank that waits longer sleeps, so that a late rank sharing
            # the core (more ranks than cores) gets to run
            spins += 1
            if spins > SPINS:
                time.sleep(2e-5)
                t0 = t0 or time.monotonic()
                if time.monotonic() - t0 > TIMEOUT_S:
                    late = np.flatnonzero(self.seq < self.n).tolist()
                    raise TimeoutError(
                        f"host collective {self.n}: ranks {late} of the "
                        f"group did not arrive within {TIMEOUT_S:.0f} s")
        return buf[:, :k]

    def _stage(self, which: str, like: torch.Tensor) -> torch.Tensor:
        """A page-locked host tensor of ``like``'s shape and dtype: the
        staging of a device tensor's copies (one of each kind is live at
        a time: a collective's device-to-host copy waits for the stream,
        so the last one's host-to-device copy has finished)."""
        nbytes = like.numel() * like.element_size()
        buf = self._pinned.get(which)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1 << 16), dtype=torch.uint8,
                              pin_memory=True)
            self._pinned[which] = buf
        return buf[:nbytes].view(like.dtype).view(like.shape)

    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        if not x.is_cuda:
            return x.detach().contiguous()
        host = self._stage("in", x)
        host.copy_(x, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
        return host

    def _to_device(self, host: torch.Tensor, like: torch.Tensor):
        """``host`` on ``like``'s device in its dtype; from the CUDA host,
        an asynchronous copy out of the staging buffer."""
        if not like.is_cuda:
            return host.to(like.dtype)
        out = self._stage("out", host)
        out.copy_(host)
        return out.to(like.device, non_blocking=True).to(like.dtype)

    def _chunks(self, host: torch.Tensor):
        raw = host.reshape(-1).view(torch.uint8).numpy()
        step = SLOT_BYTES - SLOT_BYTES % host.element_size()
        for lo in range(0, max(raw.size, 1), step):
            yield self._exchange(raw[lo:lo + step])

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` summed in fp32 in rank order, in x's dtype and
        on its device."""
        host = self._to_host(x.float())
        parts = [np.add.reduce(c.view(np.float32), axis=0)
                 for c in self._chunks(host)]
        out = torch.from_numpy(np.concatenate(parts)).reshape(x.shape)
        return self._to_device(out, x)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order."""
        host = self._to_host(x)
        rows = np.concatenate([c.copy() for c in self._chunks(host)], axis=1)
        parts = [torch.from_numpy(rows[r].copy()).view(x.dtype)
                 .reshape(x.shape) for r in range(self.size)]
        return self._to_device(torch.cat(parts, dim=dim), x)
