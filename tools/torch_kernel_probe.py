#!/usr/bin/env python3
"""Device times of the port's decode and wkv6 kernels beyond what
``chip_smoke.py`` reports, on one CUDA card:

    python3 tools/torch_kernel_probe.py

``flash_decode`` at Qwen2-1.5B's decode shape (B 8, S 1024, H 12 / Hkv 2,
d 128, bf16) under three masks (every key valid; the serve step's lengths
128 + 48 i; key 0 alone) and every split count (``bs`` 1024 .. 64 gives
1 .. 8 splits, one cluster a row), and at B 32 and 128 with every key
valid; ``wkv6``'s prefill at B 1, H 40, N 64 and T 64, 504, 1000, with
each of its three launches' device time from torch.profiler. Times are
``chip_smoke.device_ms`` (CUDA-graph replay between CUDA events).
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.flash_decode import ops as dops  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wops  # noqa: E402


def profile_kernels(fn, n=20):
    """Device us a call of each kernel ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {re.search(r"(\w+)[<(]", e.key.replace("(anonymous namespace)::",
                                                  "")).group(1):
            e.self_device_time_total / e.count
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_probe: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    B, S, H, Hkv, d = 8, 1024, 12, 2, 128
    q = torch.randn(B, H, d, generator=g, device=dev).to(bf)
    k = torch.randn(B, S, Hkv, d, generator=g, device=dev).to(bf)
    v = torch.randn(B, S, Hkv, d, generator=g, device=dev).to(bf)
    lens = torch.tensor([128 + 48 * i for i in range(B)], device=dev)
    key0 = torch.zeros(B, S, dtype=torch.bool, device=dev)
    key0[:, 0] = True
    masks = {"all valid": torch.ones(B, S, dtype=torch.bool, device=dev),
             "serve 128+48i": torch.arange(S, device=dev)[None]
             < lens[:, None],
             "key 0 alone": key0}
    for name, vm in masks.items():
        for bs in (None, 1024, 512, 256, 128, 64):
            ns = dops.plan(S, B * Hkv, dops.sm_count(0), bs).splits
            us = 1e3 * cs.device_ms(
                lambda: dops.decode_attention(q, k, v, vm, bs=bs))
            print(f"flash_decode {name:<14} bs={str(bs):<5} ({ns} splits): "
                  f"{us:.2f} us")
    for BB in (32, 128):
        qq = torch.randn(BB, H, d, generator=g, device=dev).to(bf)
        kk = torch.randn(BB, S, Hkv, d, generator=g, device=dev).to(bf)
        vm = torch.ones(BB, S, dtype=torch.bool, device=dev)
        us = 1e3 * cs.device_ms(lambda: dops.decode_attention(qq, kk, kk, vm))
        print(f"flash_decode all valid B={BB}: {us:.2f} us, "
              f"{BB * S * Hkv * 2 * d * 2 / us / 1e6:.2f} TB/s of cache")
    Hw, N = 40, 64
    for T in (64, 504, 1000):
        r, kw, vw = (torch.randn(1, T, Hw, N, generator=g, device=dev).to(bf)
                     for _ in range(3))
        w = torch.exp(-torch.exp(-2.0 + 0.5 * torch.randn(
            1, T, Hw, N, generator=g, device=dev))).to(bf)
        u = 0.1 * torch.randn(Hw, N, generator=g, device=dev)
        us = 1e3 * cs.device_ms(lambda: wops.wkv6(r, kw, vw, w, u))
        per = profile_kernels(lambda: wops.wkv6(r, kw, vw, w, u))
        print(f"wkv6 prefill T={T} ({wops.Plan(1, T, Hw, N).blocks} blocks "
              f"a chunk launch): {us:.2f} us; "
              + ", ".join(f"{k} {v:.2f} us" for k, v in per.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
