"""The attention backward kernel and the DeiT-Base train step on the card,
for the ``repro_torch`` package of any checkout, so that two trees are
compared on one card in one run.

For each case of ``chip_smoke.TRAIN_KERNEL_CASES`` (seeded inputs, the
forward kernel's o and logsumexp) it times ``backward.attention_bwd``
(CUDA events over 20 calls after 3), its launches' device time by kernel
(``torch.profiler`` over 5 calls) and SDPA's backward on the same
inputs; then a DeiT-Base train step (B 32, fp32: forward, remat, backward,
AdamW) from seeded weights, ``--steps`` times after two warm-up steps, on
the host clock around a synchronised step, as ``[train]`` reads it. It
prints one JSON line with the card's name and power limit. Usage, on a
machine with one CUDA card (parent checkout unpacked under ``build/``):

    python3 scripts/attention_bwd_probe.py --src build/parent/src --label parent
    python3 scripts/attention_bwd_probe.py --src src --label change
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the directory that holds the repro_torch package")
    ap.add_argument("--label", default="")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path[:0] = [src, ROOT]          # the package, then chip_smoke
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("attention_bwd_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import resolve_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import backward as flash_bwd
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    if not os.path.abspath(flash_bwd.__file__).startswith(src):
        raise RuntimeError(f"repro_torch imported from {flash_bwd.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"label": args.label, "card": card, "kernel_ms": {},
           "by_kernel_ms": {}, "sdpa_bwd_ms": {}}

    g = torch.Generator(device=dev).manual_seed(7)
    for tag, (B, T, S, H, Hkv, dq, dv, causal, window, dt) in \
            cs.TRAIN_KERNEL_CASES:
        dtype = getattr(torch, dt)

        def rand(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)
        q, k, v, do = rand(B, T, H, dq), rand(B, S, Hkv, dq), \
            rand(B, S, Hkv, dv), rand(B, T, H, dv)
        kw = dict(causal=causal, window=window, scale=dq ** -0.5)
        o, lse = flash_ops._forward(q, k, v, causal, window, dq ** -0.5,
                                    with_lse=True)
        out["kernel_ms"][tag] = cs.time_ms(
            lambda: flash_bwd.attention_bwd(q, k, v, o, lse, do, **kw))
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                flash_bwd.attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
        split = {}
        for e in prof.key_averages():
            m = re.search(r"(bwd_\w+)(<[^>]*>)?", e.key)
            us = getattr(e, "device_time_total", None)
            if m and us is not None:
                split[m.group(0)] = us / 5e3
        out["by_kernel_ms"][tag] = split
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt, vt = (a.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                  .detach().requires_grad_() for a in (k, v))
        if not causal and window is None:
            sdpa_kw = {}
        elif window is None and T == S:
            sdpa_kw = dict(is_causal=True)
        else:
            sdpa_kw = dict(attn_mask=flash_ref._mask(T, S, causal, window,
                                                     dev))
        y = F.scaled_dot_product_attention(qt, kt, vt, scale=dq ** -0.5,
                                           **sdpa_kw)
        dot = do.transpose(1, 2)
        out["sdpa_bwd_ms"][tag] = cs.time_ms(lambda: torch.autograd.grad(
            y, (qt, kt, vt), dot, retain_graph=True))
        del q, k, v, do, o, lse, qt, kt, vt, y, dot
    torch.cuda.empty_cache()

    cfg = resolve_config("deit-base")
    model = build_model(cfg)
    ocfg = AdamWConfig()
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    opt = adamw_init(params, ocfg)
    batch = train_mod.data_for(cfg, 0, batch=32, seq=64, device=dev)
    step = train_mod.make_train_step(model, ocfg, peak_lr=3e-4,
                                     total_steps=args.steps + 2)
    ms = []
    for i in range(args.steps + 2):
        torch.cuda.synchronize()
        t0 = time.time()
        params, opt, loss, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        if i >= 2:
            ms.append(1e3 * (time.time() - t0))
    out["deit_step_ms"] = ms
    out["deit_loss"] = float(loss)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
