#!/usr/bin/env python3
"""Host-side cost of one collective between ranks that share one card,
on a machine with one CUDA card:

    python3 tools/torch_coll_probe.py

For 2 and 4 spawned ``gloo`` ranks on ``cuda:0`` (``launch.mesh.launch``),
each variant moves a CUDA tensor of 1, 12,288 (a decode step's partial
sum) and 393,216 floats (a prefill's) to the host, combines it with the
other ranks' and copies the sum back: gloo's ``all_reduce``,
``all_gather`` and a local sum, ``gather`` to rank 0, a sum and
``broadcast``, and a spin over a shared file mapping (the scheme of
``repro_torch.distrib.hostcoll``). It prints the milliseconds a call
(host clock, 100 calls, 30 at the largest size), with the default
network interface and with ``GLOO_SOCKET_IFNAME=lo``; the JSON of each
run goes to ``build/coll_probe/coll2_<ranks>.json``.
"""
from __future__ import annotations

import json
import mmap
import os
import platform
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
MAXN = 1 << 20


class Shm:
    """Two alternating buffers of a slot a rank, and a sequence number a
    rank: write the slot, raise the number, spin until all have."""

    def __init__(self, path, world, rank, create):
        size = 8 * 2 * world + 4 * 2 * world * MAXN
        if create:
            with open(path, "wb") as f:
                f.truncate(size)
        dist.barrier()
        with open(path, "r+b") as f:
            self.mm = mmap.mmap(f.fileno(), size)
        self.seq = np.frombuffer(self.mm, np.int64, world, 0)
        self.data = np.frombuffer(self.mm, np.float32, 2 * world * MAXN,
                                  8 * 2 * world).reshape(2, world, MAXN)
        self.world, self.rank, self.n = world, rank, 0

    def all_reduce(self, x):
        self.n += 1
        buf = self.data[self.n % 2]
        k = x.size
        buf[self.rank, :k] = x
        self.seq[self.rank] = self.n
        while self.seq.min() < self.n:
            pass
        return buf[:, :k].sum(0)


def body(device, world, out, path):
    rank = dist.get_rank()
    torch.set_num_threads(2)
    shm = Shm(path, world, rank, rank == 0)
    res = {}
    for n in (1, 12288, 393216):
        x = torch.randn(n, device=device)

        def ar(t):
            h = t.cpu()
            dist.all_reduce(h)
            return h.to(device)

        def ag(t):
            h = t.cpu()
            parts = [torch.empty_like(h) for _ in range(world)]
            dist.all_gather(parts, h)
            return torch.stack(parts).sum(0).to(device)

        def gb(t):
            h = t.cpu()
            parts = [torch.empty_like(h) for _ in range(world)] \
                if rank == 0 else None
            dist.gather(h, parts, dst=0)
            if rank == 0:
                h = torch.stack(parts).sum(0)
            dist.broadcast(h, 0)
            return h.to(device)

        def sm(t):
            return torch.from_numpy(shm.all_reduce(t.cpu().numpy())) \
                .to(device)

        for tag, fn in (("allreduce", ar), ("allgather", ag),
                        ("gather_bcast", gb), ("shm", sm)):
            for _ in range(5):
                fn(x)
            torch.cuda.synchronize()
            dist.barrier()
            reps = 100 if n < 100000 else 30
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(x)
            torch.cuda.synchronize()
            res[f"{tag} {n}"] = 1e3 * (time.perf_counter() - t0) / reps
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


def main():
    from repro_torch.launch.mesh import launch
    print(platform.machine(), os.cpu_count())
    out_dir = os.path.join(ROOT, "build", "coll_probe")
    os.makedirs(out_dir, exist_ok=True)
    for ifname in ("", "lo"):
        if ifname:
            os.environ["GLOO_SOCKET_IFNAME"] = ifname
        for world in (2, 4):
            out = os.path.join(out_dir, f"coll2_{world}.json")
            with tempfile.TemporaryDirectory() as tmp:
                launch(body, world, backend="gloo", device="cuda",
                       args=(world, out, os.path.join(tmp, "slots")))
            with open(out) as f:
                print(ifname or "default-if", world, "ranks", json.load(f),
                      flush=True)


if __name__ == "__main__":
    main()
