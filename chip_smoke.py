#!/usr/bin/env python3
"""GPU smoke check of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (Hopper, ``sm_90a``) and ``nvcc``. It

  1. builds the CUDA kernels from ``src/repro_torch/kernels/*/csrc``;
  2. holds each kernel against its plain PyTorch version on the card, at
     ragged shapes and at the shapes DeiT-Base (gram fp32 and bf16,
     gram_cross at the one-traversal pass's per-sample grams), Qwen2-1.5B
     serving and RWKV6-3B serving give it (both attention kernels: fp32 on the CUDA
     cores, bf16 on the tensor cores, also at T = 197 and dq != dv; gram's
     s2 exactly symmetric at the main path's shape; flash_decode and wkv6
     bitwise equal over two calls), and times the kernel, the plain
     version and the one-call PyTorch equivalent (where one exists) beside
     the least time the card could take; flash_decode and wkv6 also
     L2-cold (rotating over a stack of per-layer slices as large as the
     path's), with the host's launch, and flash_decode at the serve step's
     mask;
 2b. training (``[kernels train]``, ``[train]``, ``[train zoo]``): the
     attention backward kernel against its plain version and against
     autograd through the plain forward at DeiT-Base, Qwen2-1.5B,
     gemma3-1b (window 512, d 256), MLA (q/k 192, v 128) and
     cross-attention shapes (fp32 <= 1e-4, bf16 <= 2e-2 of max |grad|),
     two calls bitwise equal, each case's launch plan (instance, grids,
     shared memory) printed, the backward instances' registers and spills
     read from the build's ptxas report (a spill fails), timed beside the
     plain version, SDPA's backward and its bound;
     DeiT-Base at full width and depth in fp32 through ``python -m
     repro_torch.launch.train`` (8 steps of 32 images, a checkpoint every
     4), resumed from step 4 in another directory
     (losses 5-8 within 1e-6), launches gated exactly (24 forward and 12
     backward attention launches a step, no other kernel), the host's
     batch against the step on the card, one step on the card against
     the CPU (loss 1e-4, gnorm and each leaf 1e-3); Qwen2-1.5B and
     RWKV6-3B at 4 of their 28 and 32 layers in bf16 on Zipf tokens (3
     steps each, launches gated exactly); the ``wkv6`` backward kernel
     against its plain version and autograd through the plain scan at
     RWKV6-3B's train shape (B 4, T 512, H 40, bf16), a ragged T with a
     state and a final state's gradient, T = 1, 63, 64, 65 and a small
     decay in (1e-4, 0.95) (fp32 <= 1e-4, bf16 <= 2e-2 of max |grad|), two
     calls bitwise equal, timed beside the forward, the plain version and
     its bound; ``[train zoo]``: one step of each family's reduced config
     (RWKV-6, routed MoE, MLA, the Mamba hybrid, the enc-dec) on the card
     against the CPU (loss 1e-4, gnorm and each leaf 1e-3), RWKV's
     launches gated;
  3. prune path: runs CORP pruning of DeiT-Base at full width end to end
     through ``repro_torch.launch.prune`` (seeded random weights, synthetic
     calibration images), counting each kernel's launches in that run, and
     checks the pruned model's output: finite, of the right shape, J* <=
     J_uncomp for every unit; then the prune path's other modes at full
     width, each gated on the held-out logits of the two-pass prune and on
     its kernels' launches: the bf16 stream (``gram`` on bf16, <= 1e-2),
     one traversal (``gram_cross`` through ``stats._bgram``, fp32 and
     bf16 at the default margin and a sure hit at margin 1.0, <= 1e-4), an
     interrupted and resumed calibration pass and two CLI runs on one
     ``--calib-ckpt`` (bit-identical), and ``corp_prune_streamed`` one unit
     a group (2 groups, 3 traversals, <= 1e-4); sharded calibration
     (``[calib sharded]``: ``gram_cross`` and ``flash_attention`` at a
     rank's shapes against their plain versions; four ``gloo`` ranks share
     the card as a 2 data x 2 model mesh, each placing only its
     ``forward_specs`` blocks of DeiT-Base from a tree in host memory
     (its bytes on the card within 1.01x of the blocks') and forwarding
     tensor-parallel, each launching ``gram_cross`` on its rows and its
     1536-column block of every batch's MLP tap and ``flash_attention``
     over its heads exactly, none ``gram`` or a plain version; each rank's
     s2 blocks F/2 wide, its accumulator at most half the unsharded one
     plus the replicated leaves, its pass peak <= 0.75x one device's; the
     gathered pass-1 and pass-2 statistics within 1e-4 of the single-device
     engine's; then qwen3-moe-235b-a22b at 1 layer, full width, fp32,
     experts over the model axis and rows over the data axis: pass 1 on 32
     Zipf sequences of 512, the same gates; beside them ``launch.prune
     --mesh 2x2 --calib-sharded --dist-backend gloo`` as a subprocess: the
     main path's kept sizes, held-out logits within 1e-4 of its prune's,
     equal parameter checksums and each rank's parameter bytes its
     blocks'); on a
     reduced DeiT the same pruned output on the GPU as on the CPU's plain
     path; then profiles one prune;
  4. serve path: serves a ragged trace of 16 requests with Qwen2-1.5B at
     full width and 4 of its 28 layers (seeded random bf16 weights) through
     ``repro_torch.launch.serve`` and the continuous-batching engine,
     counting the kernels' launches in that run; profiles 20 shared decode
     steps (with the decode kernel's device time a call); checks at full
     width in fp32 that teacher-forced prefill + decode logits equal one
     full forward, and on a reduced Qwen2 that the engine's token streams
     on the GPU equal the CPU plain path's; then the serving front-end at
     full width and 4 layers (``[serve frontend]``: 16 requests sharing a
     384-token prompt through ``launch.serve`` with a prefix cache of 8, a
     queue of 4 and a deadline mix: one terminal status each, every admit
     after the first a prefix hit, the attention kernels' launches equal
     28 x the prefills and the decode and walk steps, every cached entry
     bitwise as inserted; a hit's first-token logits against a cold
     prefill, <= 2e-2 in bf16) and the replica router (``[serve fleet]``,
     fp32: two replicas of 4 slots on one params tree, stepped from a
     thread each with prefix-affinity routing, whose streams equal one
     engine's, also when replica 1 is killed after its 4th decode step,
     with exact launch counts over both threads and the re-prefills'
     top-1/top-2 logit margins printed);
  5. recurrent serve path: the same for RWKV6-3B at full width and 4 of
     its 32 layers under the recurrent slot-cache contract (every prefill
     and decode step runs the ``wkv6`` kernel once per layer), with its
     slot bytes at two max_len; then sharded serving (``[serve sharded]``):
     ``--mesh-shape 1x4`` on Qwen2-1.5B (2 kv heads) refused with
     ``shard_ineligible`` before any weights load, the three kernels of
     the path against their plain versions at a rank's shapes (6/1 heads;
     wkv6 at 10 and 20 heads), and one launch of four ``gloo`` ranks
     sharing the card: Qwen2-1.5B in fp32 at full width and depth as a
     2 data x 2 model mesh, then RWKV6-3B at 8 layers as 1 x 4,
     seamless-m4t-large-v2, qwen3-moe-235b-a22b, deepseek-v3-671b (MLA)
     and jamba-1.5-large-398b (Mamba) (``SERVE_SHARDED``), 8 requests
     each through the front-end with the model axis' collectives through
     shared memory, gated on streams token-identical to the single-device
     engine's on the same seeded weights, first-step logits within 1e-4,
     each rank's parameter bytes equal to its spec blocks and cache bytes
     to ``device_bytes_estimate``, every kernel of the path launched on
     every rank; a rank's decode step and its share in collectives are
     printed; beside them the serve CLI's ``--serve-sharded --mesh-shape
     2x2 --dist-backend gloo`` (bf16, gloo collectives) serves 4 requests
     and prints its per-device cache line;
  6. LM pruning: ``gram``, ``flash_attention``, ``wkv6`` and
     ``flash_decode`` against their plain versions at the shapes of the LM
     prune and pruned-serve paths (``[kernels lm prune]``); CORP of
     Qwen2-1.5B at full width (``[prune qwen2]``: GLU MLP and class-2 rope
     attention, 128 sequences of 512 tokens from a port-only Zipf stream;
     J* <= J_uncomp, d_ff 4480 and qk 64, held-out logits finite and
     closer to the dense model's than an uncompensated prune's), the same
     in one traversal (``[prune qwen2 one traversal]``: margin 1.0 a hit
     in 1 traversal within 1e-4 of two-pass; the default margin reported),
     RWKV6-3B (``[prune rwkv]``: ``bv_comp`` in every layer, compensated
     beats uncompensated); the pruned Qwen2 saved and served through
     ``launch.serve --ckpt-in`` and the pruned RWKV through the engine
     (``[serve pruned]``); both reduced LMs pruned by ``launch.prune
     --calib-seq 16`` on the GPU and the CPU (logits within 1e-3) and
     served from the GPU's checkpoint on both (equal streams);
  7. gemma3-1b (qk-norm, 22 sliding-window layers of 512 and 4 global,
     head dim 256): ``flash_attention`` and ``flash_decode`` at d 256
     against their plain versions (``[kernels gemma]``: window and global
     prefill in bf16, a window in fp32, decode of 256/256 and pruned
     128/256 against the ring's and the global layers' masks), the serve
     trace at full width with prompts of 256-1536 tokens (``[serve
     gemma]``, with the ring layers' share of the slot bytes) and the fp32
     logit check past the window (``[gemma logits]``, two 600-token
     prefills and 8 decode steps); CORP at full width on 64 sequences of
     1024 tokens (``[prune gemma]``: class-3 attention and GELU GLU MLP,
     stacked and unrolled units; J* <= J_uncomp, d_ff 3456 and qk 128,
     an MLP-only prune closer to the dense model compensated than not,
     the class-3 numbers reported, a one-traversal hit within 1e-4 of
     two-pass); the pruned model served from its checkpoint with its
     per-head qk-norm scales (``[serve pruned gemma]``); the reduced
     gemma at 8 layers, granite-8b and deepseek-7b on the GPU against the
     CPU (``[reference gemma]``);
  8. internvl2-26b (the VLM stub frontend: patch embeddings before the
     tokens) and qwen3-moe-235b-a22b (128 routed experts, top 8, capacity
     1.25; class-3 attention): ``gram`` at the internvl MLP tap (8, 2080,
     16384) and at the MoE per-expert moments (1024 items of 160 slots,
     1536), causal GQA ``flash_attention`` at groups 6 and 16 and
     ``flash_decode`` at both, dense and pruned (``[kernels internvl
     moe]``); internvl served at full width and 16 of its 48 layers
     (weights drawn on the card) with a 256-patch prefill checked GPU
     against CPU on a reduced copy (``[serve internvl]``); CORP of
     internvl at 8 layers over Zipf tokens after 8 patches (``[prune
     internvl]``: compensated closer to the dense model than not, a
     one-traversal hit within 1e-4) and the pruned model served in process
     with its ``bd`` (``[serve pruned internvl]``; its checkpoint round
     trip runs on the reduced config in ``[reference moe]``); qwen3-moe
     at full width and 8 layers served (``[serve
     moe]``), pruned at 0.5/0.5 with one ``gram`` launch of its per-expert
     moments a batch and an MLP-only gate (``[prune moe]``), and the
     pruned model served in process with its ``bd_moe`` (``[serve pruned
     moe]``); the reduced qwen3-moe (also with ``--expert-sparsity 0.5``)
     and internvl on the GPU against the CPU, their pruned checkpoints
     served with every compensation leaf restored (``[reference moe]``);
  9. deepseek-v3-671b (MLA, 3 dense layers of 18432, 256 routed experts
     of 2048 top 8 and a shared expert) at full width and 4 of its 61
     layers: ``flash_attention`` at the MLA prefill shape (128 heads, q/k
     192 against v 128, and pruned 128/128, both at scale 1/sqrt(192)) in
     bf16 and fp32 and ``gram`` at the dense tap (3, 2048, 18432) and the
     256 expert queues (``[kernels deepseek]``); served with its latent
     cache (``[serve deepseek]``); pruned at 0.5/0.5 compensated and
     plain on 256 sequences of 512 Zipf tokens, peak device memory gated
     at 76 GB, the dense MLPs' held-out gate and the MoE blocks'
     calibration-token gate, the MLA-only error reported (``[prune
     deepseek]``), the compensated model served in process with its
     compensation leaves (``[serve pruned deepseek]``); the reduced config
     GPU against CPU: MLA prefill and decode, engine streams, and prunes
     two-pass, with ``--expert-sparsity 0.5`` and ``--one-traversal``,
     served from their checkpoints (``[reference deepseek]``);
 10. jamba-1.5-large-398b (the Mamba hybrid: 7 Mamba layers to 1
     attention layer, GQA 64/8, 16 experts of 24576 top 2 on every odd
     layer) at full width: ``flash_attention`` at 64/8 and ``flash_decode``
     at group 8, dense and pruned, and ``gram`` at the dense tap, a Mamba
     tap and the expert queues (also 4 at once, past 2^31 outputs)
     (``[kernels jamba]``); served at 5 of its 72 layers under the
     recurrent contract, the attention kernels' launches gated against the
     prefills and steps, a slot's bytes split into Mamba states and K/V
     (``[serve jamba]``); pruned at 2 layers (the served model's first
     two), compensated and plain, peak device memory gated at 76 GB, the
     Mamba and dense blocks' held-out gates and the MoE blocks'
     calibration-token gate, the Mamba-only error reported (``[prune
     jamba]``), the compensated model served in process with its
     ``out_b`` (``[serve pruned jamba]``); the reduced config GPU against
     CPU: prefill and decode, engine streams, and prunes two-pass and
     one-traversal served from their checkpoints (``[reference jamba]``);
 11. seamless-m4t-large-v2 (the encoder-decoder: 24 encoder and 24
     decoder layers, d 1024, MHA 16/16 of 64, relu^2 MLP of 8192) at full
     width and depth: ``flash_attention`` non-causal at T != S (cross
     attention: 32 and 700 decoder rows against 512 memory rows, q/k 64
     and pruned 32 against v 64, fp32 and bf16) and at the calibration
     forward, ``flash_decode`` over an all-valid memory of 500 rows and
     ``gram`` at the stacked MLP tap (24, 4096, 8192) (``[kernels
     seamless]``); served with 512 frames a request, the attention
     kernels' launches gated at 72 a prefill and 48 a decode step, a
     slot's bytes split into the decoder's and the memory's K/V
     (``[serve seamless]``); pruned in fp32 at 0.5/0.5 on 128 sequences
     of 512 Zipf tokens and 512 frames drawn on the card, compensated and
     plain, the MLP units' held-out gate, the cross unit's prune alone
     reported (``[prune seamless]``), the compensated model served in
     process (``[serve pruned seamless]``); the reduced config GPU
     against CPU: prefill and decode, engine streams, and prunes two-pass
     and one-traversal served from their checkpoints through ``--ckpt-in
     --mem-len`` (``[reference seamless]``);
 12. prints the card, a JSON line of per-kernel numbers with launches per
     path, and last the result line ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the exit code is not 0 and no result line is
printed. TF32 is switched off for matmuls and convolutions, so every plain
fp32 product is full fp32.
"""
from __future__ import annotations

import collections
import contextlib
import io
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): fp32 on
# the CUDA cores, bf16 on the tensor cores, HBM3. A bound takes the peak of
# its inputs' type.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

MAIN = dict(arch="deit-base", sparsity=0.5, calib=128, calib_batch=16)
# 16 requests, the weights drawn on the card: the script's time limit is
# shared with every later model's phases. Served at 4 of Qwen2's 28 and of
# RWKV's 32 layers (cut for [serve sharded]'s time: their gates hold at
# any depth); the pruned models serve whole (SERVE_BASE)
SERVE_BASE = ["--arch", "qwen2-1.5b", "--trace", "16", "--slots", "8",
              "--max-len", "1024", "--prompt-range", "64,512",
              "--gen-range", "32,256", "--init-on-device"]
SERVE = SERVE_BASE[:2] + ["--n-layers", "4"] + SERVE_BASE[2:]
SERVE_REDUCED = ["--arch", "qwen2-1.5b-reduced", "--trace", "12",
                 "--slots", "3", "--max-len", "96", "--prompt-range", "8,24",
                 "--gen-range", "4,16"]
SERVE_RWKV = ["--arch", "rwkv6-3b"] + SERVE[2:]
SERVE_RWKV_REDUCED = ["--arch", "rwkv6-3b-reduced"] + SERVE_REDUCED[2:]


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def kernel_modules():
    """Each kernel's wrapper module (its ``launches`` count), by name."""
    from repro_torch.kernels.flash_attention import backward as flash_bwd
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_decode import ops as decode_ops
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.wkv6 import backward as wkv_bwd
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    return {"gram": gram_ops, "flash_attention": flash_ops,
            "flash_attention_bwd": flash_bwd, "flash_decode": decode_ops,
            "wkv6": wkv_ops, "wkv6_bwd": wkv_bwd}


def reset_launches():
    for mod in kernel_modules().values():
        mod.launches = 0
    kernel_modules()["gram"].launches_by.clear()


def read_launches():
    """Launches by kernel since ``reset_launches``: the gram module's split
    into ``gram`` and ``gram_cross`` and, as ``"gram bfloat16"`` and the
    like, by input dtype."""
    mods = kernel_modules()
    out = {name: mod.launches for name, mod in mods.items() if name != "gram"}
    out.update(gram=0, gram_cross=0)
    for (op, dt), n in sorted(mods["gram"].launches_by.items()):
        out[op] += n
        out[f"{op} {dt}"] = n
    return out


def time_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=50, replays=5, warmup=3):
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed ``replays`` times between two CUDA events. Unlike ``time_ms``
    it leaves out the host's launch overhead, which is longer than a
    decode-sized kernel. It times the kernels and the library calls alike
    without torch.profiler, which in one process that had already profiled
    other calls recorded no device event for cuDNN's SDPA."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    if not ms > 0:
        fail(f"no device time measured for {fn}")
    return ms


def cold_ms(call, layers, **kw):
    """Device time per call (``device_ms``) with the inputs rotating over
    ``layers`` per-layer slices of stacked buffers, as a decode step walks
    its layers: the stack is larger than the 50 MB L2, so each call finds
    its slice cold, where ``device_ms`` of one slice finds it L2-warm."""
    turn = itertools.count()
    return device_ms(lambda: call(next(turn) % layers), reps=2 * layers,
                     **kw)


def bound_ms(flops, nbytes, peak_flops=PEAK_FP32_FLOPS):
    t_ops = flops / peak_flops
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_gram(x, y=None, tol=1e-5, label=""):
    """Kernel vs plain on the card; returns the max abs error."""
    import torch
    from repro_torch.kernels.gram import ops, ref
    got = ops.gram(x) if y is None else ops.gram_cross(x, y)
    want = ref.gram(x) if y is None else ref.gram_cross(x, y)
    torch.cuda.synchronize()
    err = max(float((got[k] - want[k]).abs().max()) for k in ("s2", "s1"))
    rel = float((got["s2"] - want["s2"]).abs().max()
                / want["s2"].abs().max())
    ok = rel <= tol and bool(torch.isfinite(got["s2"]).all())
    print(f"  gram{'' if y is None else '_cross'} {label:<28} "
          f"{str(tuple(x.shape)):>18} {str(x.dtype)[6:]:>8}: "
          f"max|ds2|/max|s2| {rel:.3e} (tol {tol:g}), max abs err "
          f"{err:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"gram {label} disagrees with its plain version")
    return err


def check_attention(q, k, v, causal, window, scale, label, tol=1e-4):
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    got = ops.attention(q, k, v, causal=causal, window=window, scale=scale)
    want = ref.attention(q, k, v, causal=causal, window=window, scale=scale)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ok = err <= tol and bool(torch.isfinite(got).all())
    print(f"  flash_attention {label:<22} q{tuple(q.shape)} "
          f"k{tuple(k.shape)} v{tuple(v.shape)}: max abs err {err:.3e} "
          f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"flash_attention {label} disagrees with its plain version")
    return err


def main_path_taps(model, params, batch):
    """One DeiT-Base forward's taps as the prune path hands them to the
    gram kernels: the layer-stacked MLP tap (L, B*T, d_ff) to ``gram``, and
    the one-traversal pass's per-sample queries (L, B, G, T, d), whose
    (L*B*G) per-sample grams ``stats._bgram`` takes in one ``gram_cross``
    launch."""
    from repro_torch.core.stats import _group_q
    taps = {}
    model.apply(params, batch, taps=taps)
    h = taps["seg0/p0/h"]
    qg = _group_q(taps["seg0/p0/q"], model.cfg.n_kv_heads)
    return h.reshape(h.shape[0], -1, h.shape[-1]), qg.contiguous()


def kernel_phase(dev):
    """Every kernel against its plain version; returns the JSON rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import resolve_config
    from repro_torch.data import calib_stream
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram import ref as gram_ref
    from repro_torch.models import build_model
    from repro_torch.models.vit import num_patches

    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    print("[kernels] each against its plain PyTorch version on the card")
    for shape in ((197 * 2, 192), (1000, 40), (37, 5)):
        check_gram(rand(*shape), label="ragged")
        check_gram(rand(*shape, dtype=torch.bfloat16), tol=1e-2,
                   label="ragged")
    check_gram(rand(1000, 40), rand(1000, 72), label="rectangular")
    check_gram(rand(3, 300, 130), rand(3, 300, 70), label="layer-stacked")

    cfg = resolve_config(MAIN["arch"])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    batch = next(iter(calib_stream(cfg, n_samples=MAIN["calib_batch"],
                                   batch=MAIN["calib_batch"], device=dev)()))
    x, xq = main_path_taps(model, params, batch)
    del params
    gram_err = check_gram(x, label="main path seg0/p0/h")
    s2 = gram_ops.gram(x)["s2"]
    symmetric = bool(torch.equal(s2, s2.mT))
    print(f"  gram main path {tuple(x.shape)} fp32: s2 equals its transpose "
          f"bit for bit: {'ok' if symmetric else 'FAIL'}")
    if not symmetric:
        fail("gram's s2 is not exactly symmetric")
    del s2

    L, N, Fd = x.shape
    g_ms = time_ms(lambda: gram_ops.gram(x))
    g_plain = time_ms(lambda: gram_ref.gram(x))
    g_lib = time_ms(lambda: torch.matmul(x.mT, x))
    # X^T X is symmetric: the function needs its upper triangle only,
    # L N F (F + 1) operations, not the full product's 2 L N F^2
    g_bound, g_by = bound_ms(1.0 * L * N * Fd * (Fd + 1),
                             4.0 * (L * N * Fd + L * Fd * Fd + L * Fd))
    print(f"  gram at {tuple(x.shape)} fp32: kernel {g_ms:.3f} ms, plain "
          f"{g_plain:.3f} ms, torch.matmul {g_lib:.3f} ms, bound "
          f"{g_bound:.3f} ms ({g_by})")
    # the bf16 stream's tap: the same values rounded to bf16, as the
    # forward under tap_dtype(bfloat16) records them
    xb = x.to(torch.bfloat16)
    g_bf16 = {"shape": list(xb.shape), "max_abs_err": check_gram(
        xb, tol=1e-2, label="main path, bf16"),
        "ms": time_ms(lambda: gram_ops.gram(xb)),
        "plain_ms": time_ms(lambda: gram_ref.gram(xb)),
        "library_ms": time_ms(lambda: torch.matmul(xb.mT, xb))}
    g_bf16["bound_ms"], g_bf16["bound_by"] = bound_ms(
        1.0 * L * N * Fd * (Fd + 1),
        2.0 * L * N * Fd + 4.0 * (L * Fd * Fd + L * Fd), PEAK_BF16_FLOPS)
    print(f"  gram at {tuple(xb.shape)} bf16: kernel {g_bf16['ms']:.3f} ms, "
          f"plain {g_bf16['plain_ms']:.3f} ms, torch.matmul (bf16 out) "
          f"{g_bf16['library_ms']:.3f} ms, bound {g_bf16['bound_ms']:.3f} ms "
          f"({g_bf16['bound_by']}, bf16 peak)")
    del x, xb

    B, T, H, dv = MAIN["calib_batch"], num_patches(cfg) + 1, cfg.n_heads, \
        cfg.d_head
    scale = 1.0 / math.sqrt(cfg.qk_full)
    mains = {}
    for dq in (cfg.qk_full, cfg.pruned(0, MAIN["sparsity"]).eff_qk):
        q, k, v = rand(B, T, H, dq), rand(B, T, H, dq), rand(B, T, H, dv)
        mains[dq] = (q, k, v, check_attention(
            q, k, v, False, None, scale, f"main path dq={dq}"))
    check_attention(rand(2, 150, 4, 64), rand(2, 150, 4, 64),
                    rand(2, 150, 4, 64), True, None, 0.125, "causal")
    check_attention(rand(2, 200, 4, 32), rand(2, 200, 4, 32),
                    rand(2, 200, 4, 64), True, 50, 0.125, "causal window")
    check_attention(rand(2, 130, 8, 64), rand(2, 130, 2, 64),
                    rand(2, 130, 2, 64), True, None, 0.125, "GQA 8/2")
    check_attention(rand(1, 70, 4, 128), rand(1, 300, 4, 128),
                    rand(1, 300, 4, 128), True, None, 0.088, "T<S, d=128")
    def rbf(*shape):
        return rand(*shape, dtype=torch.bfloat16)

    check_attention(rbf(2, 100, 4, 64), rbf(2, 100, 4, 64),
                    rbf(2, 100, 4, 64), False, None, 0.125, "bf16", tol=2e-2)
    # the tensor-core kernel at a ragged DeiT-like shape and with dq != dv
    check_attention(rbf(B, T, H, 64), rbf(B, T, H, 64), rbf(B, T, H, 64),
                    False, None, 0.125, f"bf16 T={T} full", tol=2e-2)
    check_attention(rbf(2, 150, 4, 40), rbf(2, 150, 2, 40),
                    rbf(2, 150, 2, 64), True, None, 40 ** -0.5,
                    "bf16 dq=40 dv=64", tol=2e-2)

    gc = bgram_timing(xq)
    del xq
    # gram_cross at the shape timed before it had a path: DeiT-Base's
    # 16-image token batch against its d_ff and d_model columns
    xc, yc = rand(16 * 197, cfg.d_ff), rand(16 * 197, cfg.d_model)
    dff = {"shape": [16 * 197, cfg.d_ff, cfg.d_model],
           "max_abs_err": check_gram(xc, yc, label="DeiT-Base d_ff x d_model"),
           "ms": device_ms(lambda: gram_ops.gram_cross(xc, yc)),
           "plain_ms": device_ms(lambda: gram_ref.gram_cross(xc, yc)),
           "library_ms": device_ms(lambda: torch.matmul(xc.mT, yc))}
    (Nc, Fx), Fy = xc.shape, yc.shape[1]
    dff["bound_ms"], dff["bound_by"] = bound_ms(
        2.0 * Nc * Fx * Fy, 4.0 * (Nc * Fx + Nc * Fy + Fx * Fy + Fy))
    print(f"  gram_cross at X {tuple(xc.shape)} Y {tuple(yc.shape)} fp32, "
          f"device time: kernel {dff['ms']:.4f} ms, plain "
          f"{dff['plain_ms']:.4f} ms, torch.matmul {dff['library_ms']:.4f} "
          f"ms, bound {dff['bound_ms']:.4f} ms ({dff['bound_by']})")
    gc["dff_x_dmodel"] = dff
    del xc, yc

    dq, dq_pruned = list(mains)
    q, k, v, f_err = mains[dq]
    f_ms = device_ms(lambda: flash_ops.attention(q, k, v, causal=False,
                                                 scale=scale))
    f_plain = device_ms(lambda: flash_ref.attention(q, k, v, causal=False,
                                                    scale=scale))
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    f_lib = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                             scale=scale))
    f_bound, f_by = bound_ms(2.0 * B * H * T * T * (dq + dv),
                             4.0 * B * T * H * (2 * dq + 2 * dv))
    qp, kp, vp, _ = mains[dq_pruned]
    fp_ms = device_ms(lambda: flash_ops.attention(qp, kp, vp, causal=False,
                                                  scale=scale))
    print(f"  flash_attention at B={B} T=S={T} H={H} dq={dq} dv={dv} fp32, "
          f"device time: kernel {f_ms:.4f} ms, plain {f_plain:.4f} ms, SDPA "
          f"{f_lib:.4f} ms, bound {f_bound:.4f} ms ({f_by}); "
          f"dq={dq_pruned}: kernel {fp_ms:.4f} ms")
    del mains, q, k, v, qt, kt, vt, qp, kp, vp

    return [
        {"name": "gram", "route": "cuda",
         "source": "src/repro_torch/kernels/gram/csrc/gram.cu",
         "replaces": "src/repro/kernels/gram/gram.py:104",
         "launches": None, "max_abs_err": gram_err, "ms": g_ms,
         "plain_ms": g_plain, "bound_ms": g_bound, "bound_by": g_by,
         "library_ms": g_lib, "bf16": g_bf16},
        gc,
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:73",
         "launches": None, "max_abs_err": f_err, "ms": f_ms,
         "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": f_lib, "serve_prefill": serve_prefill_timing(rand)},
        decode_kernel_phase(dev, rand),
        wkv6_kernel_phase(dev),
    ]


def bgram_timing(xq):
    """gram_cross at its path's shape: ``stats._bgram`` of the one-traversal
    pass, the per-sample grams Q_b^T Q_b of every (layer, image, group) in
    one launch, fp32 and bf16. Timed on the items as one contiguous
    (L*B*G, T, d) stack, beside its plain version and ``torch.bmm``. The
    bound counts X once (the function's one input, passed as x and y)."""
    import torch
    from repro_torch.kernels.gram import ops, ref
    x3 = xq.reshape((-1,) + tuple(xq.shape[-2:]))
    I, N, F = x3.shape
    rows = {}
    for dt, tol, peak in ((torch.float32, 1e-5, PEAK_FP32_FLOPS),
                          (torch.bfloat16, 1e-2, PEAK_BF16_FLOPS)):
        xd = xq.to(dt)
        x = x3.to(dt)
        r = {"shape": [I, N, F, F],
             "max_abs_err": check_gram(xd, xd, tol=tol,
                                       label="_bgram per-sample q"),
             "ms": device_ms(lambda: ops.gram_cross(x, x)),
             "plain_ms": device_ms(lambda: ref.gram_cross(x, x)),
             "library_ms": device_ms(lambda: torch.bmm(x.mT, x))}
        r["bound_ms"], r["bound_by"] = bound_ms(
            2.0 * I * N * F * F,
            x.element_size() * I * N * F + 4.0 * (I * F * F + I * F), peak)
        rows[str(dt)[6:]] = r
        print(f"  gram_cross at the _bgram shape ({I}, {N}, {F}) x (..., "
              f"{F}) {str(dt)[6:]}, device time: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, torch.bmm "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
        del xd, x
    f32 = rows["float32"]
    return {"name": "gram_cross", "route": "cuda",
            "source": "src/repro_torch/kernels/gram/csrc/gram.cu",
            "replaces": "src/repro/kernels/gram/gram.py:152",
            "launches": None, **f32, "bf16": rows["bfloat16"]}


def serve_prefill_timing(rand):
    """flash_attention at Qwen2-1.5B's prefill shape: one prompt bucket of
    T = 512, causal, GQA 12/2, d = 128, bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    T, H, Hkv, d = 512, 12, 2, 128
    bf = torch.bfloat16
    q, k, v = rand(1, T, H, d, dtype=bf), rand(1, T, Hkv, d, dtype=bf), \
        rand(1, T, Hkv, d, dtype=bf)
    scale = 1.0 / math.sqrt(d)
    err = check_attention(q, k, v, True, None, scale,
                          "serve prefill T=512 bf16", tol=2e-2)
    qt = q.transpose(1, 2)
    kt, vt = (a.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
              for a in (k, v))
    pairs = T * (T + 1) / 2
    calls = {"ms": lambda: ops.attention(q, k, v, causal=True, scale=scale),
             "plain_ms": lambda: ref.attention(q, k, v, causal=True,
                                               scale=scale),
             "library_ms": lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, scale=scale)}
    out = {"shape": [1, T, H, Hkv, d], "max_abs_err": err,
           **{k: device_ms(fn) for k, fn in calls.items()},
           "wall_ms": time_ms(calls["ms"])}
    out["bound_ms"], out["bound_by"] = bound_ms(
        2.0 * H * pairs * 2 * d, 2.0 * T * (2 * H + 2 * Hkv) * d,
        PEAK_BF16_FLOPS)
    print(f"  flash_attention at the serve prefill shape T=S={T} H={H} "
          f"Hkv={Hkv} d={d} causal bf16, device time: kernel "
          f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, SDPA "
          f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}); kernel with host launch "
          f"{out['wall_ms']:.4f} ms")
    return out


def check_decode(q, k, v, valid, label, tol, scale=None):
    """Kernel vs plain on the card at ``scale`` (default 1/sqrt(dq));
    returns the max abs error."""
    import torch
    from repro_torch.kernels.flash_decode import ops, ref
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    got = ops.decode_attention(q, k, v, valid, scale=scale)
    want = ref.decode_attention(q, k, v, valid, scale)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ok = err <= tol and bool(torch.isfinite(got).all())
    print(f"  flash_decode {label:<26} q{tuple(q.shape)} k{tuple(k.shape)} "
          f"v{tuple(v.shape)} {str(q.dtype)[6:]}: max abs err {err:.3e} "
          f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"flash_decode {label} disagrees with its plain version")
    return err


def decode_kernel_phase(dev, rand):
    """flash_decode against its plain version (ragged S, GQA, holes in the
    mask, the serve path's shape and its pruned dq 64 / dv 128, the serve
    step's mask), two calls bitwise equal, then its time at the path's
    shape (8 slots, S = max_len = 1024, every key valid; warm, L2-cold over
    28 layers' caches, with the host's launch) beside the plain version,
    SDPA with a boolean mask over kv heads expanded to H, and the byte
    bound; and at the serve step's mask (lengths 128 + 48 i), where the
    bound counts only the valid keys' rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import ops, ref
    g = torch.Generator(device=dev).manual_seed(1)

    def mask(B, S, holes=False):
        lens = torch.randint(1, S + 1, (B, 1), generator=g, device=dev)
        valid = torch.arange(S, device=dev)[None] < lens
        if holes:
            valid &= torch.rand(B, S, generator=g, device=dev) < 0.7
            valid[:, 0] = True
        return valid

    B, S, H, Hkv, d = 8, 1024, 12, 2, 128
    errs = {}
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        check_decode(rand(3, 4, 64, dtype=dt), rand(3, 300, 1, 64, dtype=dt),
                     rand(3, 300, 1, 64, dtype=dt), mask(3, 300),
                     "ragged S=300, GQA 4/1", tol)
        check_decode(rand(2, 8, 64, dtype=dt), rand(2, 500, 2, 64, dtype=dt),
                     rand(2, 500, 2, 64, dtype=dt), mask(2, 500, True),
                     "GQA 8/2, holes", tol)
        for dq in (d, 64):
            errs[dt, dq] = check_decode(
                rand(B, H, dq, dtype=dt), rand(B, S, Hkv, dq, dtype=dt),
                rand(B, S, Hkv, d, dtype=dt), mask(B, S),
                f"serve path dq={dq}", tol)

    bf = torch.bfloat16
    layers = 28                      # Qwen2-1.5B: one cache slice a layer
    q = rand(B, H, d, dtype=bf)
    k_all = rand(layers, B, S, Hkv, d, dtype=bf)
    v_all = rand(layers, B, S, Hkv, d, dtype=bf)
    k, v = k_all[0], v_all[0]
    valid = torch.ones(B, S, dtype=torch.bool, device=dev)
    scale = 1.0 / math.sqrt(d)
    once = ops.decode_attention(q, k, v, valid, scale=scale)
    again = ops.decode_attention(q, k, v, valid, scale=scale)
    same = bool(torch.equal(once, again))
    print(f"  flash_decode serve shape bf16: two calls bitwise equal: "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        fail("flash_decode is not deterministic")
    qt = q[:, :, None]

    def sdpa(valid):
        kt, vt = (a.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                  for a in (k, v))
        m4 = valid[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=m4, scale=scale)

    def bound(lens):
        keys = sum(lens)
        nbytes = keys * Hkv * 2 * d * 2 + 2 * (B * H * d * 2) + B * S
        return (*bound_ms(2.0 * H * keys * 2 * d, nbytes, PEAK_BF16_FLOPS),
                nbytes)

    calls = {"ms": lambda: ops.decode_attention(q, k, v, valid, scale=scale),
             "plain_ms": lambda: ref.decode_attention(q, k, v, valid, scale),
             "library_ms": sdpa(valid)}
    pl = ops.plan(S, B * Hkv, ops.sm_count(0))
    row = {"name": "flash_decode", "route": "cuda",
           "source": "src/repro_torch/kernels/flash_decode/csrc/"
                     "flash_decode.cu",
           "replaces": "src/repro/kernels/flash_decode/flash_decode.py:51",
           "launches": None, "max_abs_err": errs[bf, d],
           "splits": pl.splits,
           **{k: device_ms(fn) for k, fn in calls.items()},
           "cold_ms": cold_ms(lambda i: ops.decode_attention(
               q, k_all[i], v_all[i], valid, scale=scale), layers),
           "wall_ms": time_ms(calls["ms"], reps=50)}
    row["bound_ms"], row["bound_by"], nbytes = bound([S] * B)
    print(f"  flash_decode at B={B} S={S} H={H} Hkv={Hkv} d={d} bf16 "
          f"({pl.splits} splits of {pl.tiles} tiles), device time: kernel "
          f"{row['ms']:.4f} ms (L2-cold over {layers} layers "
          f"{row['cold_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, SDPA "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}, {nbytes / 1e6:.2f} MB); kernel with host "
          f"launch {row['wall_ms']:.4f} ms")

    # the serve step's mask: slots at lengths 128 + 48 i of max_len 1024
    lens = [128 + 48 * i for i in range(B)]
    vmask = torch.arange(S, device=dev)[None] < torch.tensor(
        lens, device=dev)[:, None]
    serve = {"lens": lens,
             "max_abs_err": check_decode(q, k, v, vmask,
                                         "serve mask 128+48i", 2e-2),
             "ms": device_ms(lambda: ops.decode_attention(
                 q, k, v, vmask, scale=scale)),
             "cold_ms": cold_ms(lambda i: ops.decode_attention(
                 q, k_all[i], v_all[i], vmask, scale=scale), layers),
             "library_ms": device_ms(sdpa(vmask))}
    serve["bound_ms"], serve["bound_by"], nbytes = bound(lens)
    row["serve_mask"] = serve
    print(f"  flash_decode at the serve mask (lengths {lens[0]}..{lens[-1]} "
          f"of {S}), device time: kernel {serve['ms']:.4f} ms (L2-cold "
          f"{serve['cold_ms']:.4f} ms), SDPA {serve['library_ms']:.4f} ms, "
          f"bound {serve['bound_ms']:.4f} ms ({serve['bound_by']}, valid "
          f"rows only, {nbytes / 1e6:.2f} MB)")
    del k_all, v_all
    return row


def check_wkv6(r, k, v, w, u, state, label, in_place=False):
    """wkv6 against its plain version; returns the max abs error on y and
    on the final state. fp32: y and state within 1e-3 abs and rel (the JAX
    package's kernel-vs-ref bound, tests/test_kernels.py:193-198); bf16
    inputs: y within 2e-2, the fp32 state within 1e-3 of its largest
    entry. ``in_place``: the kernel writes over ``state``."""
    import torch
    from repro_torch.kernels.wkv6 import ops, ref
    want_y, want_s = ref.wkv6(r, k, v, w, u, state)
    got_y, got_s = ops.wkv6(r, k, v, w, u, state,
                            out_state=state if in_place else None)
    torch.cuda.synchronize()
    err_y = float((got_y.float() - want_y.float()).abs().max())
    err_s = float((got_s - want_s).abs().max())
    fp32 = r.dtype == torch.float32
    tol = 1e-3 if fp32 else 2e-2
    ok_y = bool(((got_y.float() - want_y.float()).abs()
                 <= tol + tol * want_y.float().abs()).all())
    if fp32:
        ok_s = bool(((got_s - want_s).abs()
                     <= 1e-3 + 1e-3 * want_s.abs()).all())
    else:
        ok_s = err_s <= 1e-3 * float(want_s.abs().max())
    ok = ok_y and ok_s and bool(torch.isfinite(got_y).all()) \
        and (not in_place or got_s.data_ptr() == state.data_ptr())
    print(f"  wkv6 {label:<34} {str(tuple(r.shape)):>18} "
          f"{str(r.dtype)[6:]:>8}: max abs err y {err_y:.3e} (tol {tol:g} "
          f"abs + {tol:g} rel, max|y| {float(want_y.float().abs().max()):.1f})"
          f", state {err_s:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"wkv6 {label} disagrees with its plain version")
    return err_y, err_s


def wkv6_flops(B, T, H, N):
    """fp32 operations the function needs, by its plain recurrence: per
    token and head, y = r^T S (2 N^2), the bonus (r . (u * k)) v (5 N) and
    S' = diag(w) S + k v^T (3 N^2); 5 N^2 + 5 N in all."""
    return float((5 * N * N + 5 * N) * B * T * H)


def wkv6_bytes(B, T, H, N, itemsize, state_in):
    """r, k, v, w read and y written once in their dtype, u read, the fp32
    state written (and read when one is given)."""
    return (5 * B * T * H * N * itemsize + 4 * H * N
            + 4 * B * H * N * N * (2 if state_in else 1))


def wkv6_kernel_phase(dev):
    """wkv6 against its plain version at the serve path's shapes (the
    shared decode step in place on a slice of a stacked state, the longest
    prefill), a ragged fp32 T = 200 with an initial state, and T = 64 and
    T = 1 in fp32; then device times and bounds at both serve shapes."""
    import torch
    from repro_torch.kernels.wkv6 import ops, ref
    g = torch.Generator(device=dev).manual_seed(2)

    def inputs(B, T, H, N, dtype, state):
        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev)
        r, k, v = (randn(B, T, H, N).to(dtype) for _ in range(3))
        # w as the model makes it: exp(-exp(-2 + small)) in (0, 1)
        w = torch.exp(-torch.exp(-2.0 + 0.5 * randn(B, T, H, N))).to(dtype)
        u = 0.1 * randn(H, N)
        return r, k, v, w, u, (randn(B, H, N, N) if state else None)

    H, N = 40, 64
    bf, f32 = torch.bfloat16, torch.float32
    stacked = torch.zeros((3, 8, H, N, N), dtype=f32, device=dev)
    r, k, v, w, u, s = inputs(8, 1, H, N, bf, True)
    stacked[1] = s
    dec_err = check_wkv6(r, k, v, w, u, stacked[1],
                         "decode B=8 T=1, in place", in_place=True)
    decode = (r, k, v, w, u, stacked[1])
    pre = inputs(1, 504, H, N, bf, False)
    pre_err = check_wkv6(*pre, "longest prefill T=504")
    check_wkv6(*inputs(2, 200, 8, N, f32, True), "ragged T=200, state")
    check_wkv6(*inputs(2, 64, 8, N, f32, True), "T=64, state")
    check_wkv6(*inputs(2, 1, 8, N, f32, True), "T=1, state")

    again = stacked[1].clone()
    y1, _ = ops.wkv6(*decode[:5], again, out_state=again)
    y2, s2 = ops.wkv6(*decode[:5], stacked[1].clone())
    yp1, sp1 = ops.wkv6(*pre)
    yp2, sp2 = ops.wkv6(*pre)
    same = all(bool(torch.equal(a, b)) for a, b in
               ((y1, y2), (again, s2), (yp1, yp2), (sp1, sp2)))
    print(f"  wkv6 decode and prefill: two calls bitwise equal: "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        fail("wkv6 is not deterministic")
    del y1, y2, s2, again, yp1, yp2, sp1, sp2

    # L2-cold: a slice a layer of stacks as large as the path's (RWKV6-3B
    # has 32 layers: 32 decode states of 10.5 MB, 32 prefill inputs)
    layers = 32
    r, k, v, w, u, _ = decode
    st_all = stacked[1].expand(layers, *stacked.shape[1:]).clone()
    dec_in = [torch.stack([t] * layers) for t in (r, k, v, w)]
    pre_in = [torch.stack([t] * layers) for t in pre[:4]]
    cold = {
        "decode": lambda i, u=u: ops.wkv6(*(t[i] for t in dec_in), u,
                                          st_all[i], out_state=st_all[i]),
        "prefill": lambda i: ops.wkv6(*(t[i] for t in pre_in), pre[4])}
    rows = {}
    for name, (r, k, v, w, u, s), plain_kw in (
            ("decode", decode, {}),
            ("prefill", pre, dict(reps=2, replays=2, warmup=1))):
        B, T = r.shape[:2]
        out = {"shape": [B, T, H, N],
               "blocks": ops.Plan(B, T, H, N).blocks}
        call = (lambda r=r, k=k, v=v, w=w, u=u, s=s:
                ops.wkv6(r, k, v, w, u, s, out_state=s))
        out["ms"] = device_ms(call)
        out["cold_ms"] = cold_ms(cold[name], layers)
        out["wall_ms"] = time_ms(call, reps=50)
        out["plain_ms"] = device_ms(lambda: ref.wkv6(r, k, v, w, u, s),
                                    **plain_kw)
        out["bound_ms"], out["bound_by"] = bound_ms(
            wkv6_flops(B, T, H, N),
            wkv6_bytes(B, T, H, N, r.element_size(), s is not None))
        rows[name] = out
        print(f"  wkv6 at the serve {name} shape B={B} T={T} H={H} N={N} "
              f"bf16 ({out['blocks']} blocks a launch), device time: kernel "
              f"{out['ms']:.4f} ms (L2-cold over {layers} layers "
              f"{out['cold_ms']:.4f} ms), plain {out['plain_ms']:.4f} ms, "
              f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}); kernel "
              f"with host launch {out['wall_ms']:.4f} ms; no single "
              f"PyTorch call computes it")
    del st_all, dec_in, pre_in
    d = rows["decode"]
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6/wkv6.py:76",
            "launches": None, "max_abs_err": dec_err[0],
            "max_abs_err_state": dec_err[1], "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None,
            "shape": d["shape"], "cold_ms": d["cold_ms"],
            "wall_ms": d["wall_ms"],
            "serve_prefill": dict(rows["prefill"],
                                  max_abs_err=pre_err[0],
                                  max_abs_err_state=pre_err[1])}


def prune_args(arch, device, out, extra=()):
    return ["--arch", arch, "--sparsity", str(MAIN["sparsity"]),
            "--calib", str(MAIN["calib"]),
            "--calib-batch", str(MAIN["calib_batch"]),
            "--device", device, "--out", out, *extra]


def profile_phase(dev):
    """Where the main path's time goes: the host time to make and upload
    one calibration batch, then device time by kernel over ``corp_prune``
    of the main path's model on two batches already on the card, and the
    share of that wall time the device was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import resolve_config
    from repro_torch.core import PruneConfig, corp_prune
    from repro_torch.data import calib_stream
    from repro_torch.models import build_model
    B = MAIN["calib_batch"]
    cfg = resolve_config(MAIN["arch"])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    stream = calib_stream(cfg, n_samples=2 * B, batch=B, device=dev)
    t0 = time.time()
    batches = list(stream())
    torch.cuda.synchronize()
    data_ms = 1e3 * (time.time() - t0) / len(batches)
    pc = PruneConfig(MAIN["sparsity"], MAIN["sparsity"])
    corp_prune(model, params, lambda: iter(batches), pc)      # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        _, _, report = corp_prune(model, params, lambda: iter(batches), pc)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    # device-side rows only (kernels, copies): CPU ops would count their
    # kernels a second time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[profile] host: {data_ms:.1f} ms to make and upload one "
          f"calibration batch of {B} images (numpy)")
    print(f"[profile] corp_prune of {MAIN['arch']} over {2 * B} images on "
          f"the card, profiled: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%), stages "
          + " / ".join(f"{k} {1e3 * v:.1f} ms"
                       for k, v in report["timing"].items()))
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<5} "
              f"{e.key[:90]}")


def rel_err(a, b):
    return float((a - b).norm() / b.norm())


def check_report(tag, report):
    for unit, d in report["units"].items():
        js, ju = d["j_star"], d["j_uncomp"]
        bad = js > ju * (1 + 1e-5) + 1e-6
        if bad.any():
            fail(f"{tag}: {unit}: j_star > j_uncomp at {bad.nonzero()}")


def stages(report):
    return " / ".join(f"{k} {v:.3f} s" for k, v in report["timing"].items())


def held_out(cfg, dev):
    """The held-out batch every prune phase's pruned model is read on."""
    from repro_torch.data import vit_batch
    held = vit_batch(0, batch=MAIN["calib_batch"], img=cfg.img_size,
                     n_classes=cfg.n_classes, seed=1234, device=dev)
    return {"images": held["images"]}


def pruned_logits(res, batch):
    from repro_torch.models import build_model
    return build_model(res["pruned_cfg"]).apply(res["pruned_params"], batch)


def main_path_phase(dev):
    """DeiT-Base CORP pruning end to end; returns ({kernel: launches}, the
    held-out batch, the pruned model's logits on it, its kept (d_ff,
    qk))."""
    import torch
    from repro_torch.launch import prune

    print(f"[main path] python -m repro_torch.launch.prune "
          f"{' '.join(prune_args(MAIN['arch'], 'cuda', OUT))}")
    reset_launches()
    t0 = time.time()
    res = prune.main(prune_args(MAIN["arch"], "cuda", OUT))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    t = res["report"]["timing"]
    print(f"[main path] wall {wall:.3f} s; stages: " + " / ".join(
        f"{k} {t[k]:.3f} s" for k in ("pass1", "rank", "pass2", "fold")))
    print(f"[main path] kernel launches in this run: {launches}")
    for name in ("gram", "flash_attention"):
        if launches[name] <= 0:
            fail(f"the main path never launched the {name} kernel")

    check_report("main path", res["report"])
    print("[main path] j_star <= j_uncomp for every unit and layer")

    cfg = res["model"].cfg
    batch = held_out(cfg, dev)
    dense = res["model"].apply(res["params"], batch)
    pruned = pruned_logits(res, batch)
    if pruned.shape != (MAIN["calib_batch"], cfg.n_classes) \
            or not bool(torch.isfinite(pruned).all()):
        fail(f"pruned logits of shape {tuple(pruned.shape)} or not finite")
    comp = rel_err(pruned, dense)
    del res
    res_nc = prune.main(prune_args(MAIN["arch"], "cuda",
                                   OUT + "_nocomp", ["--no-compensate"]))
    nocomp = rel_err(pruned_logits(res_nc, batch), dense)
    print(f"[main path] held-out batch, |pruned - dense| / |dense| logits: "
          f"compensated {comp:.4f}, --no-compensate {nocomp:.4f} "
          f"(d_ff {cfg.d_ff} -> {res_nc['pruned_cfg'].eff_d_ff}, qk "
          f"{cfg.qk_full} -> {res_nc['pruned_cfg'].eff_qk})")
    return launches, batch, pruned, (res_nc["pruned_cfg"].eff_d_ff,
                                     res_nc["pruned_cfg"].eff_qk)


def cli_prune_phase(tag, extra, kernels):
    """The prune CLI at the main path's settings plus ``extra``; each of
    ``kernels`` (a key of ``read_launches``) must have launched. Returns
    ({kernel: launches}, the CLI's result, wall seconds)."""
    import torch
    from repro_torch.launch import prune
    args = prune_args(MAIN["arch"], "cuda", f"{OUT}_{tag.replace(' ', '_')}",
                      extra)
    print(f"[{tag}] python -m repro_torch.launch.prune {' '.join(args)}")
    reset_launches()
    t0 = time.time()
    res = prune.main(args)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    rep = res["report"]
    print(f"[{tag}] wall {wall:.3f} s; stages: {stages(rep)}; traversals "
          f"{rep['traversals']}; kernel launches: {launches}")
    for name in kernels:
        if launches.get(name, 0) <= 0:
            fail(f"the {tag} path never launched {name}")
    check_report(tag, rep)
    return launches, res, wall


def bf16_phase(batch, ref):
    """--stats-dtype bfloat16: the taps stream in bf16 into the gram
    kernel; the pruned logits within 1e-2 of the fp32 stream's."""
    launches, res, _ = cli_prune_phase(
        "main path bf16", ["--stats-dtype", "bfloat16"],
        ("gram bfloat16", "flash_attention"))
    logits = pruned_logits(res, batch)
    err = rel_err(logits, ref)
    print(f"[main path bf16] held-out batch, |bf16 stream - fp32 stream| / "
          f"|fp32 stream| pruned logits: {err:.3e} (tol 1e-2)")
    if not err <= 1e-2:
        fail("the bf16-streamed pruned model is more than 1e-2 from the "
             "fp32-streamed one")
    return launches, logits


def one_traversal_phase(batch, refs):
    """--one-traversal, fp32 and bf16, each at the default margin and at
    margin 1.0 (a sure hit): gram_cross runs (``_bgram``), and the pruned
    logits are within 1e-4 of the two-pass run's of the same streaming
    dtype (a miss re-passes and gives the two-pass sums; a hit rebuilds
    them from the speculative sums of the same taps, ~1e-6 away).
    Returns {path: launches}."""
    out = {}
    bf16 = ["--stats-dtype", "bfloat16"]
    # margin 1.0, every dim a candidate: a sure hit, so the reconstruction
    # runs at full width (Gc 144 x 64^4 fp32, 9.7 GB)
    hit = ["--spec-margin", "1.0"]
    for tag, dt, extra in (
            ("one traversal", "float32", []),
            ("one traversal bf16", "bfloat16", bf16),
            ("one traversal hit", "float32", hit),
            ("one traversal bf16 hit", "bfloat16", bf16 + hit)):
        launches, res, _ = cli_prune_phase(
            tag, ["--one-traversal", *extra], (f"gram_cross {dt}", "gram"))
        rep = res["report"]
        sp = rep["speculative"]
        err = rel_err(pruned_logits(res, batch), refs[dt])
        del res
        print(f"[{tag}] traversals {rep['traversals']}, margin "
              f"{sp['margin']}, candidates {sp['candidates']}, hits "
              f"{sp['hits']}, misses {sp['misses']}; gram_cross launches "
              f"{launches['gram_cross']}; held-out |one - two-pass| / "
              f"|two-pass| pruned logits {err:.3e} (tol 1e-4)")
        if not err <= 1e-4:
            fail(f"{tag}: the one-traversal pruned model is more than 1e-4 "
                 f"from the two-pass one")
        if tag.endswith("hit") and (rep["traversals"] != 1 or sp["misses"]):
            fail(f"{tag}: a full candidate set missed")
        out[f"prune_{tag.replace(' ', '_')}"] = launches
    return out


def calib_ckpt_phase(dev):
    """An interrupted and resumed phase-1 pass equals an uninterrupted one
    bit for bit, and reduced only the batches after its checkpoint (half
    the kernel launches); then the prune CLI twice with one --calib-ckpt:
    the second run restores every pass whole (no kernel launch) and its
    pruned weights equal the first's bit for bit."""
    import shutil
    import torch
    from repro_torch.configs import resolve_config
    from repro_torch.core import CalibrationEngine, discover_units
    from repro_torch.data import calib_stream
    from repro_torch.distrib import CalibrationCheckpointer
    from repro_torch.interop import flatten
    from repro_torch.models import build_model
    cfg = resolve_config(MAIN["arch"])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    B = MAIN["calib_batch"]
    stream = calib_stream(cfg, n_samples=4 * B, batch=B, device=dev)
    units = discover_units(cfg)
    ck = os.path.join(OUT + "_ckpt", "engine")
    shutil.rmtree(OUT + "_ckpt", ignore_errors=True)

    def engine():
        return CalibrationEngine(model, units, phase=1)

    t0 = time.time()
    engine().run(params, itertools.islice(stream(), 2),
                 checkpointer=CalibrationCheckpointer(ck, every=1))
    t_cut = time.time() - t0
    reset_launches()
    t0 = time.time()
    resumed = engine().run(params, stream(),
                           checkpointer=CalibrationCheckpointer(ck, every=1))
    t_resume = time.time() - t0
    n_resumed = read_launches()
    reset_launches()
    whole = engine().run(params, stream())
    n_whole = read_launches()
    a, b = flatten(resumed), flatten(whole)
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    print(f"[calib ckpt] phase-1 pass over 2 of 4 batches saving every batch "
          f"{t_cut:.3f} s, resumed over all 4 {t_resume:.3f} s: every leaf "
          f"equal to an uninterrupted pass's: {'ok' if same else 'FAIL'}; "
          f"gram / flash_attention launches resumed {n_resumed['gram']} / "
          f"{n_resumed['flash_attention']}, uninterrupted {n_whole['gram']} "
          f"/ {n_whole['flash_attention']}")
    if not same:
        fail("a resumed calibration pass differs from an uninterrupted one")
    for name in ("gram", "flash_attention"):
        if not 0 < 2 * n_resumed[name] == n_whole[name]:
            fail(f"the resumed pass launched {name} {n_resumed[name]} times, "
                 f"not half of the uninterrupted pass's {n_whole[name]}: it "
                 f"did not skip the checkpointed batches")
    del params, resumed, whole, a, b

    extra = ["--calib-ckpt", OUT + "_ckpt", "--calib-ckpt-every", "4"]
    runs = []
    for i in range(2):
        launches, res, wall = cli_prune_phase(
            f"calib ckpt run {i + 1}", extra, ("gram",) if i == 0 else ())
        runs.append((flatten(res["pruned_params"]), wall))
        del res
        if i == 1 and (launches["gram"] or launches["flash_attention"]):
            fail("the resumed prune ran a calibration forward: every pass "
                 "should have been restored from its checkpoint")
    (p1, w1), (p2, w2) = runs
    same = p1.keys() == p2.keys() and all(torch.equal(p1[k], p2[k])
                                          for k in p1)
    print(f"[calib ckpt] CLI wall {w1:.3f} s, resumed {w2:.3f} s; pruned "
          f"weights equal bit for bit: {'ok' if same else 'FAIL'}")
    if not same:
        fail("the resumed prune's weights differ from the first run's")
    shutil.rmtree(OUT + "_ckpt", ignore_errors=True)


def streamed_phase(dev, batch, ref):
    """corp_prune_streamed one unit at a time: DeiT-Base's 2 stacked units
    (attention, MLP) are 2 groups and 3 traversals (2 for the attention
    group, 1 for the MLP group); pruned logits within 1e-4 of corp_prune's.
    Returns {kernel: launches}."""
    import torch
    from repro_torch.configs import resolve_config
    from repro_torch.core import PruneConfig, corp_prune_streamed
    from repro_torch.data import calib_stream
    from repro_torch.models import build_model
    cfg = resolve_config(MAIN["arch"])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    stream = calib_stream(cfg, n_samples=MAIN["calib"],
                          batch=MAIN["calib_batch"], device=dev)
    reset_launches()
    t0 = time.time()
    new, new_cfg, rep = corp_prune_streamed(
        model, params, stream, PruneConfig(MAIN["sparsity"], MAIN["sparsity"]),
        unit_group_size=1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    check_report("streamed", rep)
    err = rel_err(build_model(new_cfg).apply(new, batch), ref)
    print(f"[streamed] corp_prune_streamed(unit_group_size=1): wall "
          f"{wall:.3f} s; stages {stages(rep)}; {rep['groups']} groups, "
          f"{rep['traversals']} traversals; launches {launches}; held-out "
          f"|streamed - corp_prune| / |corp_prune| pruned logits {err:.3e} "
          f"(tol 1e-4)")
    if rep["traversals"] != 3 or rep["groups"] != 2:
        fail("streamed CORP did not take 2 groups and 3 traversals")
    if not err <= 1e-4:
        fail("streamed CORP is more than 1e-4 from corp_prune")
    return launches


# [calib sharded]: four gloo ranks on one card, a 2 data x 2 model mesh,
# each holding only its forward_specs blocks of the parameters (placed from
# a tree in host memory) and forwarding tensor-parallel; the engine-level
# checks stream 32 of the main path's 128 images (cut: the single-device
# reference runs beside them), the CLI all 128. A rank's pass peak (the
# memory it allocates above what it held when the pass began, up to the
# gather, less its placed blocks, as the single-device pass's parameters
# are held before it begins) is gated at `peak` x the single-device pass's:
# its rows and its statistics' columns both halve, so it is near half; its
# whole footprint (blocks and peak) against the single-device parameters'
# and peak likewise. A rank's placed bytes on the card are gated at
# `placed` x the bytes of its forward_specs blocks
SHARDED = dict(mesh=(2, 2), images=32, tol=1e-4, peak=0.75, placed=1.01)
# then qwen3-moe at 1 of its 94 layers, full width (experts over the model
# axis, rows over the data axis): pass 1 over 32 port-only Zipf sequences
# of 512 in batches of 16, against the single-device engine on rank 0. In
# fp32 (14.9 GB whole): in bf16 the tensor-parallel attention output
# rounds otherwise than one device's in a few elements, and at random
# init that moves a few dozen of the 78k (token, expert) picks to other
# experts (tools/moe_tp_routing_probe.py: 29, s2 4.9e-3 from one device,
# where one device at another batch size moves none and is within
# 2.3e-7), so no bf16 split meets 1e-4. The tokens are drawn on the host
# (zipf_tokens)
SHARDED_MOE = dict(arch="qwen3-moe-235b-a22b", layers=1, dtype="float32",
                   seqs=32, seq=512, batch=16, seed=23)


def measure_place(shard, device):
    """Wrap ``shard.place`` so that each placement appends the bytes
    ``torch.cuda.memory_allocated`` grew by across it to the returned
    list."""
    import torch
    placed, place = [], shard.place

    def measured(params):
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        blocks = place(params)
        torch.cuda.synchronize(device)
        placed.append(torch.cuda.memory_allocated(device) - before)
        return blocks
    shard.place = measured
    return placed


def forward_block_bytes(params, shard):
    """The bytes of this rank's ``forward_specs`` blocks of ``params``, cut
    from meta tensors (shapes only) by ``shard_params``."""
    import torch
    import torch.distributed as dist
    from repro_torch.distrib.sharding import forward_specs, shard_params
    from repro_torch.interop import flatten, map_tree
    meta = map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), params)
    blocks = shard_params(meta, forward_specs(meta, shard.sizes), shard.mesh,
                          dist.get_rank())
    return sum(t.numel() * t.element_size() for t in flatten(blocks).values())


def tree_bytes(tree):
    from repro_torch.interop import flatten
    return sum(t.numel() * t.element_size() for t in flatten(tree).values())


def check_placed(tag, rank, eng, placed, want):
    """A pass's placement gates: the engine's ``param_bytes`` equal to the
    rank's ``forward_specs`` blocks' bytes ``want``, and the card's
    allocation across the placement at most ``SHARDED['placed']`` x
    them."""
    if eng.param_bytes != want or not placed[-1] <= SHARDED["placed"] * want:
        fail(f"[{tag}] rank {rank}: placed {placed[-1]} B on the card, "
             f"engine param_bytes {eng.param_bytes} B, its forward_specs "
             f"blocks {want} B (gate {SHARDED['placed']:g}x)")


def calib_sharded_rank(device, out_dir):
    """One rank of ``[calib sharded]``: pass 1 and pass 2 of DeiT-Base on
    the main path's weights (in host memory) and stream, sharded over the
    2 x 2 mesh, each gated on its placed parameter bytes (its
    ``forward_specs`` blocks), launches (``gram_cross`` once a batch and
    MLP unit, ``flash_attention`` once a batch and layer, no ``gram``, no
    plain-version call) and footprint (every dense s2 block F/m wide, the
    accumulator at most half the unsharded one plus its replicated leaves);
    the mesh's first rank also holds the gathered statistics against the
    single-device engine's on the card (relative Frobenius error a leaf),
    and each rank's peak of a pass, up to the gather that returns the full
    statistics, against that engine's. Then pass 1 of qwen3-moe at one
    layer (``moe_rank``). Writes ``rank<r>.json``; a failed gate raises,
    which fails the launch."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import resolve_config
    from repro_torch.core import CalibrationEngine, discover_units, ranking
    from repro_torch.data import calib_stream
    from repro_torch.distrib import CalibSharding, stats_specs
    from repro_torch.interop import flatten, map_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    cfg = resolve_config(MAIN["arch"])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    B = MAIN["calib_batch"]
    stream = calib_stream(cfg, n_samples=SHARDED["images"], batch=B,
                          device=device)
    n_batches = SHARDED["images"] // B
    units = discover_units(cfg)
    dense = [u.name for u in units if u.kind == "mlp"]
    shard = CalibSharding(make_mesh(SHARDED["mesh"], device_type="cuda"))
    placed = measure_place(shard, device)
    blocks_bytes, whole_bytes = forward_block_bytes(params, shard), \
        tree_bytes(params)
    plain = [0]
    for mod in kernel_modules().values():       # count plain-version calls
        for name in [n for n in dir(mod._ref) if not n.startswith("_")]:
            fn = getattr(mod._ref, name)
            if callable(fn) and getattr(fn, "__module__", "") \
                    == mod._ref.__name__:
                def counted(*a, _fn=fn, **k):
                    plain[0] += 1
                    return _fn(*a, **k)
                setattr(mod._ref, name, counted)
    def held():
        """The bytes allocated now, the peak counter reset to them."""
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        return torch.cuda.memory_allocated(device)

    out = {"rank": rank, "param_bytes_whole": whole_bytes,
           "param_bytes_blocks": blocks_bytes}
    plan, on_card = None, None
    for phase in (1, 2):
        kw = dict(phase=phase, plan=plan)
        start = held()
        reset_launches()
        plain[0] = 0
        t0 = time.time()
        eng = CalibrationEngine(model, units, mesh=shard, **kw)
        gathered, at_gather = eng._gathered, []

        def before_gather(acc, _gathered=gathered):
            # the pass's peak before the gather, which returns the full
            # statistics on every rank as the single-device engine does
            torch.cuda.synchronize(device)
            at_gather.append(torch.cuda.max_memory_allocated(device))
            return _gathered(acc)
        eng._gathered = before_gather
        got = eng.run(params, stream())
        torch.cuda.synchronize(device)
        wall = time.time() - t0
        launches, calls = read_launches(), plain[0]
        check_placed("calib sharded", rank, eng, placed, blocks_bytes)
        specs = flatten(stats_specs(got, shard))
        full = flatten(got)
        total = sum(t.numel() * t.element_size() for t in full.values())
        replicated = sum(t.numel() * t.element_size()
                         for k, t in full.items() if specs[k] is None)
        rec = {"wall_s": wall, "launches": launches, "plain_calls": calls,
               "local_bytes": eng.local_bytes, "unsharded_bytes": total,
               "replicated_bytes": replicated,
               "param_bytes": eng.param_bytes, "placed_bytes": placed[-1],
               "max_memory_allocated": torch.cuda.max_memory_allocated(
                   device),
               "footprint_bytes": at_gather[0] - start,
               "peak_bytes": at_gather[0] - start - placed[-1],
               "s2_blocks": {u: eng.local_shapes.get(f"{u}/s2")
                             for u in dense} if phase == 1 else {}}
        out[f"pass{phase}"] = rec
        want_cross = n_batches * len(dense) if phase == 1 else 0
        want_attn = n_batches * cfg.n_layers
        if launches["gram_cross"] != want_cross or launches["gram"] \
                or calls or launches["flash_attention"] != want_attn:
            fail(f"[calib sharded] rank {rank} pass {phase}: gram_cross "
                 f"{launches['gram_cross']} launches (want {want_cross}), "
                 f"flash_attention {launches['flash_attention']} (want "
                 f"{want_attn}), gram {launches['gram']}, plain-version "
                 f"calls {calls}")
        for u, shape in rec["s2_blocks"].items():
            F = full[f"{u}/s2"].shape[-1]
            if shape is None or shape[-1] != F // shard.model_size:
                fail(f"[calib sharded] rank {rank}: {u} s2 block {shape}, "
                     f"not F/m = {F // shard.model_size} columns")
        if not eng.local_bytes <= total / 2 + replicated:
            fail(f"[calib sharded] rank {rank} pass {phase}: accumulator "
                 f"{eng.local_bytes} B > half of {total} B + {replicated} "
                 f"B replicated")
        if rank == 0:
            if on_card is None:
                on_card = map_tree(lambda t: t.to(device), params)
            start = held()
            ref = CalibrationEngine(model, units, **kw).run(on_card,
                                                            stream())
            torch.cuda.synchronize(device)
            rec["unsharded_peak_bytes"] = \
                torch.cuda.max_memory_allocated(device) - start
            errs = {k: rel_err(full[k].double(), t.double())
                    for k, t in flatten(ref).items()}
            rec["max_rel_err"] = max(errs.values())
            rec["worst_leaf"] = max(errs, key=errs.get)
            if full.keys() != errs.keys() \
                    or not rec["max_rel_err"] <= SHARDED["tol"]:
                fail(f"[calib sharded] pass {phase}: gathered statistics "
                     f"{rec['max_rel_err']:.3e} from the single-device "
                     f"engine's at {rec['worst_leaf']} (tol "
                     f"{SHARDED['tol']:g})")
            del ref
        if phase == 1:
            plan = {}
            for u in units:
                if u.kind == "attn":
                    st = {k: v.cpu().numpy() for k, v in got[u.name].items()}
                    plan[u.name] = ranking.rank_attn(
                        st, int(round(st["rank"].shape[-1]
                                      * (1 - MAIN["sparsity"]))))
        del got, full
    del on_card, params
    torch.cuda.empty_cache()
    out["moe"] = moe_rank(device, shard, placed, held)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def moe_rank(device, shard, placed, held):
    """qwen3-moe at ``SHARDED_MOE['layers']`` layer, full width, on the
    rank: the ranks in turns draw the whole model on the card from a
    seeded generator (the same weights on every rank), place their blocks
    from it (``CalibSharding.place``: its experts and heads, a vocab block
    of the embedding and head) and drop it before the next rank draws
    (four whole fp32 trees, 59.7 GB, would not fit in host memory beside
    the rest, and a tree moved there costs seconds a rank: the DeiT-Base
    case places from the host); then pass 1 of the engine over the Zipf
    stream on the placed blocks, gated on the placed bytes, launches
    (``gram_cross`` and ``flash_attention`` once a batch, no ``gram``)
    and, on rank 0, the gathered statistics within ``SHARDED['tol']`` of
    the single-device engine's on the same weights, drawn again. Returns
    the rank's record."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import resolve_config
    from repro_torch.core import CalibrationEngine, discover_units
    from repro_torch.interop import flatten
    from repro_torch.models import build_model
    rank = dist.get_rank()
    c = SHARDED_MOE
    cfg = resolve_config(c["arch"]).replace(n_layers=c["layers"],
                                            dtype=c["dtype"])
    model = build_model(cfg)
    def draw():
        return model.init(torch.Generator(device=device).manual_seed(0),
                          device=device)
    t0 = time.time()
    for turn in range(dist.get_world_size()):
        if turn == rank:
            params = draw()
            rec = {"arch": cfg.name, "layers": cfg.n_layers,
                   "dtype": cfg.dtype,
                   "param_bytes_whole": tree_bytes(params),
                   "param_bytes_blocks": forward_block_bytes(params, shard)}
            blocks = shard.place(params)
            rec["placed_bytes"] = placed[-1]
            del params
            torch.cuda.empty_cache()
        dist.barrier()
    rec["init_s"] = time.time() - t0
    tokens = zipf_tokens(cfg.vocab_size, c["seqs"], c["seq"], c["seed"],
                         torch.device("cpu")).to(device)
    batches = [{"tokens": tokens[i:i + c["batch"]]}
               for i in range(0, c["seqs"], c["batch"])]
    units = discover_units(cfg)
    start = held()
    reset_launches()
    t0 = time.time()
    eng = CalibrationEngine(model, units, phase=1, mesh=shard)
    got = eng.run(blocks, batches)
    torch.cuda.synchronize(device)
    del blocks
    rec.update(wall_s=time.time() - t0, launches=read_launches(),
               param_bytes=eng.param_bytes, local_bytes=eng.local_bytes,
               footprint_bytes=torch.cuda.max_memory_allocated(device)
               - start)
    check_placed("calib sharded moe", rank, eng, [rec["placed_bytes"]],
                 rec["param_bytes_blocks"])
    n = len(batches)
    la = rec["launches"]
    if la["gram_cross"] != n or la["gram"] or la["flash_attention"] != n:
        fail(f"[calib sharded moe] rank {rank}: gram_cross "
             f"{la['gram_cross']}, flash_attention {la['flash_attention']} "
             f"launches (want {n} each), gram {la['gram']}")
    if rank == 0:
        full = flatten(got)
        del got
        torch.cuda.empty_cache()
        on_card = draw()
        start = held()
        ref = flatten(CalibrationEngine(model, units, phase=1).run(
            on_card, batches))
        torch.cuda.synchronize(device)
        rec["unsharded_peak_bytes"] = \
            torch.cuda.max_memory_allocated(device) - start
        errs = {k: rel_err(full[k].double(), t.double())
                for k, t in ref.items()}
        rec["max_rel_err"] = max(errs.values())
        rec["worst_leaf"] = max(errs, key=errs.get)
        rec["errs"] = errs
        if full.keys() != errs.keys() \
                or not rec["max_rel_err"] <= SHARDED["tol"]:
            fail(f"[calib sharded moe] gathered statistics "
                 f"{rec['max_rel_err']:.3e} from the single-device "
                 f"engine's at {rec['worst_leaf']} (tol {SHARDED['tol']:g})")
        del ref, on_card, full
    torch.cuda.empty_cache()
    return rec


def sharded_kernel_phase(dev, by_name):
    """The kernels of ``[calib sharded]`` at a rank's shapes, each against
    its plain version and event-timed beside it, the one-call PyTorch
    equivalent and its bound; added to the JSON line's rows:
    ``gram_cross`` at a DeiT-Base rank's MLP block (its 8 of 16 images'
    tap (12, 1576, 3072) against its 1536-column block, a strided view of
    the tap: ``gram_ops.gram_sharded``) and at a qwen3-moe rank's expert
    moments (128 expert queues of its 2 routing groups' 160 slots, (128,
    320, 1536) against 768 columns), fp32; ``flash_attention`` over a
    DeiT-Base rank's 6 of 12 heads (B 8, T 197, d 64, fp32, full) and a
    qwen3-moe rank's 32 of 64 query and 2 of 4 kv heads (B 8, T 512, d
    128, causal, in ``SHARDED_MOE``'s dtype, fp32: the kernel instance
    that case launches). The gram bound reads the tap once (the block is
    part of it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.gram import ops, ref
    gen = torch.Generator(device=dev).manual_seed(9)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    for key, shape, Fb in (("calib_sharded_rank", (12, 1576, 3072), 1536),
                           ("calib_sharded_moe", (128, 320, 1536), 768)):
        x = rand(*shape)
        y = x[..., -Fb:]
        L, N, Fx = x.shape
        r = {"shape": [L, N, Fx, Fb],
             "max_abs_err": check_gram(x, y, label=f"{key} block"),
             "ms": time_ms(lambda: ops.gram_cross(x, y), reps=5, warmup=1),
             "plain_ms": time_ms(lambda: ref.gram_cross(x, y), reps=5,
                                 warmup=1),
             "library_ms": time_ms(lambda: torch.matmul(x.mT, y), reps=5,
                                   warmup=1)}
        r["bound_ms"], r["bound_by"] = bound_ms(
            2.0 * L * N * Fx * Fb + L * N * Fb,
            4.0 * (L * N * Fx + L * Fx * Fb + L * Fb))
        print(f"  gram_cross at {key}'s block X {tuple(x.shape)} Y "
              f"{tuple(y.shape)} (strided) fp32: kernel {r['ms']:.3f} ms, "
              f"plain {r['plain_ms']:.3f} ms, torch.matmul "
              f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']})")
        by_name["gram_cross"][key] = r
        del x, y
    for key, (B, T, H, Hkv, d), dt, causal in (
            ("calib_sharded_rank", (8, 197, 6, 6, 64), torch.float32, False),
            ("calib_sharded_moe", (8, 512, 32, 2, 128),
             getattr(torch, SHARDED_MOE["dtype"]), True)):
        q, k, v = rand(B, T, H, d, dtype=dt), rand(B, T, Hkv, d, dtype=dt), \
            rand(B, T, Hkv, d, dtype=dt)
        scale = 1.0 / math.sqrt(d)
        err = check_attention(q, k, v, causal, None, scale, key,
                              tol=1e-4 if dt == torch.float32 else 2e-2)
        qt = q.transpose(1, 2)
        kt, vt = (a.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                  for a in (k, v))
        calls = {"ms": lambda: fa_ops.attention(q, k, v, causal=causal,
                                                scale=scale),
                 "plain_ms": lambda: fa_ref.attention(q, k, v, causal=causal,
                                                      scale=scale),
                 "library_ms": lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, is_causal=causal, scale=scale)}
        r = {"shape": [B, T, H, Hkv, d], "dtype": str(dt)[6:],
             "causal": causal, "max_abs_err": err,
             **{name: device_ms(fn) for name, fn in calls.items()}}
        pairs = T * (T + 1) / 2 if causal else T * T
        r["bound_ms"], r["bound_by"] = bound_ms(
            2.0 * B * H * pairs * 2 * d,
            q.element_size() * B * T * (2 * H + 2 * Hkv) * d,
            PEAK_FP32_FLOPS if dt == torch.float32 else PEAK_BF16_FLOPS)
        print(f"  flash_attention at {key}'s heads B={B} T={T} H={H} "
              f"Hkv={Hkv} d={d} {r['dtype']}{' causal' if causal else ''}, "
              f"device time: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        by_name["flash_attention"][key] = r
        del q, k, v, qt, kt, vt


def calib_sharded_phase(dev, batch, ref, kept):
    """``[calib sharded]``: four ranks share the card over ``gloo``
    (NCCL takes one rank a card). The engine-level checks of
    ``calib_sharded_rank`` through ``launch.mesh.launch`` and, at the same
    time, the prune CLI with ``--mesh 2x2 --calib-sharded --dist-backend
    gloo`` as a subprocess: its checkpoint holds the main path's kept
    sizes, its held-out logits are within 1e-4 of the single-device
    prune's (``ref``), the four ranks' parameter checksums are equal and
    its ranks' parameter bytes on the card are their blocks'. Each rank's
    pass peaks are gated against the single-device engine's. Times here
    are of four ranks on one card: they say nothing of scaling. Returns
    the DeiT-Base passes' launches and qwen3-moe's, each summed over the
    ranks."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import resolve_config
    from repro_torch.launch.mesh import launch
    from repro_torch.models import build_model
    out_dir = OUT + "_sharded_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    torch.cuda.empty_cache()
    world = math.prod(SHARDED["mesh"])
    out = OUT + "_sharded"
    args = prune_args(MAIN["arch"], "cuda", out,
                      ["--mesh", "x".join(map(str, SHARDED["mesh"])),
                       "--calib-sharded", "--dist-backend", "gloo"])
    print(f"[calib sharded] python -m repro_torch.launch.prune "
          f"{' '.join(args)}, beside the engine's ranks")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    # the CLI's ranks and the engine's run at once (eight processes on the
    # card): their cold starts overlap
    t0 = time.time()
    cli = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.prune",
                            *args], env=env, cwd=ROOT, text=True,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    done = {}

    def drain():
        done["out"], done["err"] = cli.communicate()
        done["wall"] = time.time() - t0
    reader = threading.Thread(target=drain)
    reader.start()
    try:
        launch(calib_sharded_rank, world, backend="gloo", device="cuda",
               args=(out_dir,))
        wall = time.time() - t0
        reader.join(timeout=600)
    finally:
        if cli.poll() is None:
            cli.kill()
        reader.join()
    recs = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
            for r in range(world)]
    print(f"[calib sharded] {world} gloo ranks on one card, mesh "
          f"{SHARDED['mesh']} (data x model), {SHARDED['images']} images: "
          f"launch wall {wall:.3f} s (ranks sharing the card with the "
          f"CLI's)")
    for r in recs:      # a JSON line a rank: walls of ranks sharing a card
        print(json.dumps({"calib_sharded_rank": r}))
        print(f"[calib sharded] rank {r['rank']} DeiT-Base parameters on "
              f"the card: {r['pass1']['placed_bytes']} B placed a pass "
              f"(its forward_specs blocks {r['param_bytes_blocks']} B, gate "
              f"{SHARDED['placed']:g}x) of the whole tree's "
              f"{r['param_bytes_whole']} B in host memory")
        for phase in ("pass1", "pass2"):
            p = r[phase]
            single = recs[0][phase]["unsharded_peak_bytes"]
            whole = single + r["param_bytes_whole"]
            print(f"[calib sharded] rank {r['rank']} {phase}: accumulator "
                  f"{p['local_bytes']} B of {p['unsharded_bytes']} B "
                  f"unsharded ({p['replicated_bytes']} B replicated), "
                  f"max_memory_allocated {p['max_memory_allocated']} B; "
                  f"peak above the pass's start and its blocks, to the "
                  f"gather, {p['peak_bytes']} B against the single-device "
                  f"pass's {single} B ({p['peak_bytes'] / single:.3f}, "
                  f"gate {SHARDED['peak']:g}); with the blocks "
                  f"{p['footprint_bytes']} B against the single-device "
                  f"parameters and peak {whole} B "
                  f"({p['footprint_bytes'] / whole:.3f}, gate "
                  f"{SHARDED['peak']:g})"
                  + (f", s2 blocks {p['s2_blocks']}" if p["s2_blocks"]
                     else "")
                  + (f"; gathered vs single-device max relative error "
                     f"{p['max_rel_err']:.3e} at {p['worst_leaf']} (tol "
                     f"{SHARDED['tol']:g})" if "max_rel_err" in p else ""))
            if not (p["peak_bytes"] <= SHARDED["peak"] * single
                    and p["footprint_bytes"] <= SHARDED["peak"] * whole):
                fail(f"[calib sharded] rank {r['rank']} {phase}: peak "
                     f"{p['peak_bytes']} B (with its blocks "
                     f"{p['footprint_bytes']} B) > {SHARDED['peak']:g} x the "
                     f"single-device pass's {single} B ({whole} B)")
    for r in recs:
        m = r["moe"]
        print(f"[calib sharded moe] rank {r['rank']} {m['arch']} at "
              f"{m['layers']} layer {m['dtype']}, {SHARDED_MOE['seqs']} Zipf "
              f"sequences of {SHARDED_MOE['seq']}: parameters on the card "
              f"{m['placed_bytes']} B placed (its forward_specs blocks "
              f"{m['param_bytes_blocks']} B, gate {SHARDED['placed']:g}x) "
              f"of the whole model's {m['param_bytes_whole']} B "
              f"({m['param_bytes_whole'] * world} B replicated on "
              f"{world} ranks); pass 1 wall {m['wall_s']:.3f} s (the "
              f"ranks' draws and placements {m['init_s']:.3f} s), "
              f"footprint {m['footprint_bytes']} B, "
              f"accumulator {m['local_bytes']} B; launches "
              f"gram_cross {m['launches']['gram_cross']}, flash_attention "
              f"{m['launches']['flash_attention']}"
              + (f"; gathered vs single-device max relative error "
                 f"{m['max_rel_err']:.3e} at {m['worst_leaf']} (tol "
                 f"{SHARDED['tol']:g}; the single-device pass's peak "
                 f"{m['unsharded_peak_bytes']} B)" if "max_rel_err" in m
                 else ""))
    cli_wall = done["wall"]
    print("\n".join("  " + ln for ln in done["out"].splitlines()))
    if cli.returncode != 0:
        print(done["err"][-4000:], file=sys.stderr)
        fail(f"[calib sharded] the sharded prune CLI exited {cli.returncode}")
    line = [ln for ln in done["out"].splitlines() if "checksums:" in ln]
    sums = json.loads(line[0].split("checksums:")[1]) if line else []
    if len(sums) != world or len(set(sums)) != 1:
        fail(f"[calib sharded] rank checksums {sums}: not {world} equal")
    # the kept sizes the CLI wrote: its checkpoint's MLP and query widths
    with np.load(os.path.join(out, "step_00000000", "arrays.npz")) as z:
        wrote = (z["seg0/p0/mlp/wd"].shape[-2],
                 z["seg0/p0/mixer/wq"].shape[-1])
    if wrote != kept:
        fail(f"[calib sharded] the CLI's checkpoint keeps (d_ff, qk) "
             f"{wrote}, not the main path's {kept}")
    ncfg = resolve_config(MAIN["arch"]).pruned(MAIN["sparsity"],
                                               MAIN["sparsity"])
    model = build_model(ncfg)
    like = model.init(torch.Generator().manual_seed(0), device=dev)
    params, _ = restore_checkpoint(out, 0, like)
    err = rel_err(model.apply(params, batch), ref)
    launches, moe_launches = {}, {}
    for r in recs:
        for phase in ("pass1", "pass2"):
            for k, n in r[phase]["launches"].items():
                launches[k] = launches.get(k, 0) + n
        for k, n in r["moe"]["launches"].items():
            moe_launches[k] = moe_launches.get(k, 0) + n
    line = [ln for ln in done["out"].splitlines() if "parameter bytes" in ln]
    cli_bytes = json.loads(line[0].split(": ", 1)[1].split(" of ")[0]) \
        if line else []
    print(json.dumps({"calib_sharded_cli": {
        "wall_s": cli_wall, "kept": list(wrote),
        "checksums": sums, "param_bytes": cli_bytes,
        "held_out_rel_err": err, "tol": SHARDED["tol"],
        "engine_launches": launches, "moe_launches": moe_launches}}))
    if sorted(cli_bytes) != sorted(r["param_bytes_blocks"] for r in recs):
        fail(f"[calib sharded] the CLI's ranks placed {cli_bytes} B of "
             f"parameters, not their forward_specs blocks")
    print(f"[calib sharded] CLI wall {cli_wall:.3f} s (its ranks beside the "
          f"engine's on one card); kept d_ff {wrote[0]}, qk {wrote[1]}; rank "
          f"checksums equal; held-out |sharded - single-device| / "
          f"|single-device| pruned logits {err:.3e} (tol "
          f"{SHARDED['tol']:g})")
    if not err <= SHARDED["tol"]:
        fail("[calib sharded] the sharded prune is more than 1e-4 from the "
             "single-device one")
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches, moe_launches


def reference_phase(dev):
    """Reduced DeiT-Base pruned on the GPU (kernels) and on the CPU (plain
    path) from the same seed: the pruned outputs must agree."""
    import torch
    from repro_torch.data import vit_batch
    from repro_torch.launch import prune
    from repro_torch.models import build_model
    arch = "deit-base-reduced"
    outs = {}
    for device in ("cuda", "cpu"):
        res = prune.main(prune_args(arch, device, f"{OUT}_{device}"))
        cfg = res["pruned_cfg"]
        x = vit_batch(7, batch=8, img=cfg.img_size, n_classes=cfg.n_classes,
                      seed=1234, device=device)["images"]
        outs[device] = build_model(cfg).apply(res["pruned_params"],
                                              {"images": x}).cpu()
    err = rel_err(outs["cuda"], outs["cpu"])
    # the Cholesky solves and the SVD fold run in another order on the two
    # devices, and the SVD's paired signs may differ: outputs agree to 1e-3
    print(f"[reference] {arch}: pruned logits GPU vs CPU relative error "
          f"{err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        fail("pruned model on the GPU disagrees with the CPU's plain path")


def serve_phase(args, tag, kernels):
    """Serve the ragged trace through the CLI's engine path at full width;
    every kernel in ``kernels`` must have launched. Returns ({kernel:
    launches}, the CLI's result)."""
    import torch
    from repro_torch.launch import serve
    print(f"[{tag}] python -m repro_torch.launch.serve {' '.join(args)}")
    reset_launches()
    t0 = time.time()
    res = serve.main(args)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    st, table = res["stats"], res["table"]
    cfg = res["model"].cfg
    prefills = sum(v for k, v in st.items() if k.startswith("prefill_b"))
    print(f"[{tag}] wall {wall:.3f} s (init of the seeded weights, "
          f"warmup and the trace); kernel launches in this run: {launches}")
    print(f"[{tag}] trace: {table['wall_s']:.3f} s, {table['tokens']} "
          f"tokens, {table['tok_per_s']:.1f} tok/s, TTFT p50/p99 "
          f"{table['ttft_p50_ms']:.1f}/{table['ttft_p99_ms']:.1f} ms, "
          f"latency p50/p99 {table['lat_p50_ms']:.1f}/"
          f"{table['lat_p99_ms']:.1f} ms; "
          f"{1e3 * st['decode_s'] / max(1, st['decode_steps']):.2f} ms per "
          f"shared decode step ({st['decode_steps']} steps), "
          f"{1e3 * st['prefill_s'] / max(1, prefills):.2f} ms per prefill "
          f"({prefills} prefills), {st.get('walk_steps', 0)} batch-1 walk "
          f"steps")
    print(f"[{tag}] engine stats: {dict(sorted(st.items()))}")
    print(f"[{tag}] table: {json.dumps(table)}")
    for name in kernels:
        if launches[name] <= 0:
            fail(f"the {tag} path never launched the {name} kernel")
    for c in res["completions"]:
        if not (len(c.tokens) >= 1 and ((0 <= c.tokens)
                                        & (c.tokens < cfg.vocab_size)).all()):
            fail(f"request {c.rid}: tokens out of range or missing")
    return launches, res


def recurrent_checks(launches, res):
    """RWKV6-3B serving: every prefill, batch-1 walk step and shared decode
    step launched wkv6 once per layer, and a slot's cache bytes do not
    depend on max_len."""
    from repro_torch.serve import ServeEngine
    model = res["model"]

    def calls(st):
        return (st.get("decode_steps", 0) + st.get("walk_steps", 0)
                + sum(v for k, v in st.items() if k.startswith("prefill_b")))

    warm, trace = calls(res["warmup_stats"]), calls(res["stats"])
    need = model.cfg.n_layers * (warm + trace)
    print(f"[serve rwkv] wkv6 launches {launches['wkv6']} == "
          f"{model.cfg.n_layers} layers x ({warm} warmup + {trace} trace) "
          f"forward calls = {need}")
    if launches["wkv6"] != need:
        fail("the recurrent serve path's wkv6 launches do not match its "
             "forward calls")
    sizes = {n: ServeEngine(model, res["params"], n_slots=8, max_len=n)
             .slotcache.slot_bytes for n in (512, 1024)}
    print(f"[serve rwkv] slot-cache bytes per slot: max_len 512 "
          f"{sizes[512]}, max_len 1024 {sizes[1024]}")
    if sizes[512] != sizes[1024]:
        fail("the recurrent slot cache grows with max_len")


def serve_profile_phase(model, params, dev, tag, kernel, device_name,
                        steps=20):
    """Eight slots of ragged lengths decoding on the full-width model: host
    ms per shared decode step, then a profile of ``steps`` steps (device
    busy share, ``kernel``'s launches, top device ops). Returns the device
    ms per call of the device kernels whose names hold ``device_name``."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request, ServeEngine
    mod = kernel_modules()[kernel]
    eng = ServeEngine(model, params, n_slots=8, max_len=1024)
    eng.begin()
    rng = np.random.RandomState(3)
    for i in range(8):
        eng.admit(Request(rid=i, tokens=rng.randint(
            0, model.cfg.vocab_size, size=128 + 48 * i).astype(np.int32),
            gen=3 * steps + 10), i)
    for _ in range(3):
        eng.decode_step()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(steps):
        eng.decode_step()
    step_ms = 1e3 * (time.time() - t0) / steps
    mod.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(steps):
            eng.decode_step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[{tag}] {steps} decode steps, 8 slots at lengths "
          f"128..464, max_len 1024: {step_ms:.2f} ms per step unprofiled; "
          f"profiled wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {n_kernels / steps:.0f} device "
          f"ops and {mod.launches / steps:.0f} {kernel} launches "
          f"per step; nvidia-smi clocks.sm, power.draw, power.limit: {smi}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5} "
              f"{e.key[:90]}")
    mine = [e for e in events if device_name in e.key]
    calls = sum(e.count for e in mine)
    if not calls:
        fail(f"{tag}: no device event of {device_name}")
    per_call = sum(e.self_device_time_total for e in mine) / 1e3 / calls
    print(f"[{tag}] {device_name}: {1e3 * per_call:.2f} us of device time "
          f"a call ({calls} calls in {steps} steps)")
    return per_call


def logit_phase(model, params, tag, lens):
    """Full width in fp32 (TF32 off): two requests teacher-forced through
    prefill (ragged on an attention stack, of equal lengths otherwise) and
    8 decode steps; every step's logits against one full forward over the
    same tokens, relative error <= 1e-3."""
    import numpy as np
    import torch
    from repro_torch.interop import map_tree
    from repro_torch.models import build_model
    cfg = model.cfg.replace(dtype="float32")
    m32 = build_model(cfg)
    p32 = map_tree(lambda t: t.float(), params)
    dev = p32["embed"].device
    rng = np.random.RandomState(7)
    n_dec = 8
    seqs = [rng.randint(0, cfg.vocab_size, size=n + n_dec).astype(np.int32)
            for n in lens]
    toks = np.zeros((2, max(lens)), np.int32)
    for r, n in enumerate(lens):
        toks[r, :n] = seqs[r][:n]
    full = [m32.apply(p32, {"tokens": torch.from_numpy(q[None]).to(dev)})[0]
            [0] for q in seqs]
    ragged = set(cfg.layer_kinds) == {"attn"}
    logits, cache = m32.prefill(
        p32, {"tokens": torch.from_numpy(toks).to(dev)}, 64 + max(lens),
        lengths=torch.tensor(lens, device=dev) if ragged else None)
    errs = [rel_err(logits[r, 0], full[r][n - 1])
            for r, n in enumerate(lens)]
    for i in range(n_dec):
        tok = torch.tensor([[q[n + i]] for q, n in zip(seqs, lens)],
                           dtype=torch.int32, device=dev)
        logits, cache = m32.decode_step(p32, tok, cache)
        errs += [rel_err(logits[r, 0], full[r][n + i])
                 for r, n in enumerate(lens)]
    err = max(errs)
    print(f"[{tag}] {cfg.name} fp32 at full width, prefill of {lens} + "
          f"{n_dec} teacher-forced decode steps vs one full forward: max "
          f"relative error {err:.3e} over {len(errs)} logit rows (tol 1e-3)")
    if not err <= 1e-3:
        fail(f"{cfg.name}: decode logits disagree with the full forward")


def serve_reference_phase(args, tag):
    """A reduced config (fp32) served on the GPU (kernels) and on the CPU
    (plain path) from the same seed: the token streams must be equal."""
    from repro_torch.launch import serve
    streams = {}
    for device in ("cuda", "cpu"):
        res = serve.main(args + ["--device", device])
        streams[device] = [c.tokens.tolist() for c in res["completions"]]
    same = streams["cuda"] == streams["cpu"]
    print(f"[{tag}] {args[1]} engine streams, GPU vs CPU: "
          f"{sum(map(len, streams['cuda']))} tokens, "
          f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        fail(f"{args[1]}: the engine's streams on the GPU differ from the "
             f"CPU's")


# ---------------------------------------------------------------------------
# the serving front-end (bounded queue, deadlines, prefix cache) and the
# replica router at Qwen2-1.5B's full width and depth
# ---------------------------------------------------------------------------

# 16 requests sharing a 384-token system prompt, suffixes of 4-16 tokens;
# half of them carry a deadline of 0.5-4 s and 4 of the 16 wait in the queue
SERVE_FRONTEND = ["--arch", "qwen2-1.5b", "--trace", "16", "--slots", "8",
                  "--max-len", "1024", "--prompt-range", "4,16",
                  "--gen-range", "16,64", "--prefix-cache", "8",
                  "--prefix-len", "384", "--queue-depth", "4",
                  "--deadline-ms", "500,4000", "--deadline-frac", "0.5",
                  "--init-on-device", "--n-layers", "4"]     # 4 of 28
# in process, fp32: 8 requests sharing a 128-token prompt, two replicas of 4
# slots with prefix-affinity routing against one engine of 4 slots
FLEET = dict(n=8, prefix_len=128, prompt_range=(4, 16), gen_range=(16, 32),
             slots=4, max_len=256, cap=4, kill_after=4)


def attention_calls(st):
    """(prefills, shared decode steps + batch-1 walk steps) of an engine's
    stats: each runs ``flash_attention`` or ``flash_decode`` once a layer."""
    return (sum(v for k, v in st.items() if k.startswith("prefill_b")),
            st.get("decode_steps", 0) + st.get("walk_steps", 0))


def check_attention_launches(tag, launches, layers, stats):
    """Each kernel's launches against ``layers`` x the engines' calls."""
    pre = sum(attention_calls(st)[0] for st in stats)
    dec = sum(attention_calls(st)[1] for st in stats)
    print(f"[{tag}] flash_attention launches {launches['flash_attention']} "
          f"== {layers} layers x {pre} prefills; flash_decode launches "
          f"{launches['flash_decode']} == {layers} layers x {dec} decode and "
          f"walk steps")
    if (launches["flash_attention"], launches["flash_decode"]) \
            != (layers * pre, layers * dec):
        fail(f"{tag}: the attention kernels' launches do not match the "
             f"engines' prefills and steps")


class EntryWatch:
    """Keeps, on the card, a copy of every prefix-cache entry as it is
    inserted and the prompts of every lookup that hit, by patching
    ``PrefixCache`` for the length of a ``with`` block."""

    def __enter__(self):
        import torch
        from repro_torch.interop import map_tree
        from repro_torch.serve.prefix import PrefixCache
        self.cls, self.snaps, self.hits = PrefixCache, {}, set()
        self.orig = (PrefixCache.insert, PrefixCache.lookup)
        insert, lookup = self.orig
        watch = self

        def watched_insert(pc, tokens, cache, nbytes):
            key = pc._key(tokens)
            if key not in pc._entries:
                watch.snaps[key] = map_tree(torch.clone, cache)
            insert(pc, tokens, cache, nbytes)

        def watched_lookup(pc, tokens, whole_entry=False):
            hit = lookup(pc, tokens, whole_entry)
            if hit is not None:
                watch.hits.add(pc._key(tokens))
            return hit

        PrefixCache.insert, PrefixCache.lookup = watched_insert, \
            watched_lookup
        return self

    def __exit__(self, *exc):
        self.cls.insert, self.cls.lookup = self.orig

    def changed(self, pc):
        """Entries of ``pc`` whose tensors differ from their insert."""
        import torch
        from repro_torch.interop import flatten
        bad = 0
        for key, e in pc._entries.items():
            got, want = flatten(e.cache), flatten(self.snaps[key])
            bad += not all(torch.equal(got[k], want[k]) for k in want)
        return bad


class FirstLogits:
    """Records, on ``engines``, the logits each admit takes its first token
    from: the last ``_argmax`` of the admit, which closes a cold prefill
    or, on a prefix hit, the last batch-1 walk step. Armed only around an
    admit on the calling thread (``with watch.admit() as first:``), so
    the shared decode steps that replicas run from threads record
    nothing."""

    def __init__(self, engines):
        self.engines, self.armed, self.last = engines, False, None
        for e in engines:
            e._argmax = self._hook(e, e._argmax)

    def _hook(self, engine, argmax):
        def recorded(logits):
            if self.armed:
                self.last = (engine, logits[0, -1, :engine.cfg.vocab_size]
                             .float())
            return argmax(logits)
        return recorded

    @contextlib.contextmanager
    def admit(self):
        """Yields a dict that holds, on exit, the admit's ``logits``, the
        ``engine`` that made them, its ``path`` ("prefill" or "hit + s walk
        steps") and the top-1 minus top-2 logit ``margin``."""
        before = [(e.stats["prefix_hits"], e.stats["walk_steps"])
                  for e in self.engines]
        self.armed, self.last, out = True, None, {}
        try:
            yield out
        finally:
            self.armed = False
        if self.last is None:
            return                     # no replica took the admit
        engine, logits = self.last
        hits, walk = before[self.engines.index(engine)]
        top = logits.topk(2).values
        out.update(logits=logits, engine=engine,
                   margin=float(top[0] - top[1]),
                   path=("prefill" if engine.stats["prefix_hits"] == hits
                         else f"hit + {engine.stats['walk_steps'] - walk} "
                              f"walk steps"))


def hit_logits_phase(model, params, reqs):
    """The engine's prefix-hit path against its cold path, in the served
    dtype: a ``ServeEngine`` admits request A with a prefix cache, then B,
    which hits A's entry and walks its suffix by batch-1 decode steps; B's
    first-token logits from that walk are held against the engine's cold
    admit of B (no cache), relative error <= 2e-2 (bf16, the attention
    gate), the argmax agreement reported."""
    from repro_torch.serve import PrefixCache, ServeEngine
    eng = ServeEngine(model, params, n_slots=2, max_len=1024)
    eng.begin()
    watch = FirstLogits([eng])
    errs, agree = [], 0
    pairs = list(zip(reqs[:-1], reqs[1:]))[:3]
    for a, b in pairs:
        pc = PrefixCache(cap=2)
        eng.admit(a, 0, prefix_cache=pc)
        with watch.admit() as hit:
            eng.admit(b, 1, prefix_cache=pc)
        eng.reset()
        with watch.admit() as cold:
            eng.admit(b, 0)
        eng.reset()
        if hit.get("path", "prefill") == "prefill" \
                or cold.get("path") != "prefill":
            fail(f"request {b.rid}: the hit took the {hit.get('path')} path, "
                 f"the cold admit {cold.get('path')}")
        got, want = hit["logits"], cold["logits"]
        errs.append(rel_err(got, want))
        agree += int(got.argmax()) == int(want.argmax())
    err = max(errs)
    print(f"[serve frontend] prefix hit: first-token logits vs a cold "
          f"prefill of the same prompt (one ServeEngine, admit with and "
          f"without a prefix cache), {len(pairs)} prompts of "
          f"{[len(b.tokens) for _, b in pairs]} tokens: max relative error "
          f"{err:.3e} (tol 2e-2), argmax agrees on {agree}/{len(pairs)} "
          f"(reported, not gated in {model.cfg.dtype})")
    if not err <= 2e-2:
        fail("a prefix hit's logits disagree with a cold prefill")


def serve_frontend_phase():
    """Qwen2-1.5B at full width and depth (bf16, weights drawn on the
    card) through ``launch.serve``'s front-end with a prefix cache, a
    queue of 4 and a deadline mix: every handle ends in exactly one
    terminal status; every admit after the first hits the first's entry
    (admits are atomic, so each sees the insert before it) and reuses the
    shared tokens; the attention kernels launched once a layer for
    each prefill and for each shared decode and batch-1 walk step; every
    entry still cached is bitwise what was inserted. Returns ({kernel:
    launches}, the CLI's result)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.serve.queue import TERMINAL
    tag = "serve frontend"
    arg = dict(zip(SERVE_FRONTEND[::2], SERVE_FRONTEND[1::2]))
    n, shared = int(arg["--trace"]), int(arg["--prefix-len"])
    print(f"[{tag}] python -m repro_torch.launch.serve "
          f"{' '.join(SERVE_FRONTEND)}")
    reset_launches()
    t0 = time.time()
    with EntryWatch() as watch:
        res = serve.main(SERVE_FRONTEND)
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    st, warm, table = res["stats"], res["warmup_stats"], res["table"]
    fe, handles = res["frontend"], res["handles"]
    cfg = res["model"].cfg
    pc = fe.prefix_cache
    counts = {k: table[k] for k in ("done", "rejected", "expired",
                                    "cancelled", "failed")}
    print(f"[{tag}] wall {wall:.3f} s (init, warmup and the trace); "
          f"outcomes {counts}; kernel launches in this run: {launches}")
    print(f"[{tag}] engine stats: {dict(sorted(st.items()))}")
    print(f"[{tag}] prefix cache: {pc.stats()}")
    print(f"[{tag}] table: {json.dumps(table)}")
    if not all(h.status in TERMINAL for h in handles) \
            or sum(counts.values()) != n or len(handles) != n:
        fail(f"{tag}: a request did not reach exactly one terminal status")
    if st["prefix_hits"] != st["admits"] - 1 or st["prefix_hits"] < 1:
        fail(f"{tag}: {st['prefix_hits']} prefix hits for {st['admits']} "
             f"atomic admits")
    if st["prefix_reused_tokens"] < shared * st["prefix_hits"]:
        fail(f"{tag}: the hits reused fewer than the {shared} shared "
             f"tokens")
    check_attention_launches(tag, launches, cfg.n_layers, (warm, st))
    if launches["gram"] or launches["wkv6"]:
        fail(f"{tag}: a kernel off the serve path launched")
    bad = watch.changed(pc)
    print(f"[{tag}] {len(pc)} entries still cached "
          f"({pc.bytes / 1e6:.1f} MB), each held bitwise to its copy at "
          f"insertion: {len(pc) - bad} unchanged, {bad} changed")
    if bad:
        fail(f"{tag}: a prefix-cache entry changed after its insert")
    for h in handles:
        toks = np.asarray(h.tokens)
        if not ((0 <= toks) & (toks < cfg.vocab_size)).all():
            fail(f"{tag}: request {h.rid}: tokens out of range")
    served = [h for h in handles if h.t_first is not None]
    hits = [h.ttft for h in served if h.req.tokens.tobytes() in watch.hits]
    cold = [h.ttft for h in served
            if h.req.tokens.tobytes() not in watch.hits]
    prefills, steps = attention_calls(st)

    def pct(xs):
        return (f"{1e3 * np.percentile(xs, 50):.1f}/"
                f"{1e3 * np.percentile(xs, 99):.1f} ms over {len(xs)}"
                if xs else "none")
    print(f"[{tag}] TTFT p50/p99: prefix hits {pct(hits)}, cold admits "
          f"{pct(cold)}; {1e3 * st['walk_s'] / max(1, st['walk_steps']):.2f}"
          f" ms per batch-1 walk step ({st['walk_steps']} steps over "
          f"{st['prefix_suffix_tokens']} suffix tokens), "
          f"{1e3 * st['decode_s'] / max(1, st['decode_steps']):.2f} ms per "
          f"shared decode step ({st['decode_steps']} steps), "
          f"{1e3 * st['prefill_s'] / max(1, prefills):.2f} ms per cold "
          f"prefill ({prefills})")
    hit_logits_phase(res["model"], res["params"],
                     sorted((h.req for h in handles), key=lambda r: r.rid))
    return launches, res


def fleet_run(m32, p32, trace, n_engines, route=None, kill=False):
    """The trace through ``ServeFrontend`` over one engine with a prefix
    cache, or over a ``ReplicaRouter`` of ``n_engines`` by ``route``
    (prefix-affinity with a cache a replica, least-loaded with none);
    ``kill`` kills replica 1 after its ``kill_after``-th decode step.
    Returns (streams, router or None, wall seconds, launches, engine
    stats, re-dispatches: [(rid, tokens delivered, the survivor's path to
    its first token, that token's top-1 minus top-2 logit)])."""
    import torch
    from repro_torch.serve import (PrefixCache, ReplicaRouter, ServeEngine,
                                   ServeFrontend)
    engines = [ServeEngine(m32, p32, n_slots=FLEET["slots"],
                           max_len=FLEET["max_len"])
               for _ in range(n_engines)]
    for e in engines:
        e.warmup(prompt_lens=[len(r.tokens) for r in trace], prefix=True)
    redispatched = []
    if n_engines > 1:
        eng = ReplicaRouter(engines, route=route, prefix_cap=FLEET["cap"]
                            if route == "prefix-affinity" else 0)
        fe = ServeFrontend(eng, queue_depth=16)
        watch, bind = FirstLogits(engines), eng._bind

        def watched_bind(gid, req, prefix_cache=None, begin=False):
            v = eng.vslots[gid]
            if not v.out:                         # a first admit
                return bind(gid, req, prefix_cache, begin)
            with watch.admit() as first:
                ok = bind(gid, req, prefix_cache, begin)
            if not ok:
                return ok
            if first.get("engine") is not engines[v.replica]:
                fail(f"[serve fleet] rid {v.rid}: the first token's logits "
                     f"came from another replica than its survivor")
            redispatched.append((v.rid, len(v.out), first["path"],
                                 first["margin"]))
            return ok
        eng._bind = watched_bind
    else:
        eng = None
        fe = ServeFrontend(engines[0], queue_depth=16,
                           prefix_cache=PrefixCache(cap=FLEET["cap"]))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    handles = [fe.submit(r) for r in trace]
    killed = False
    while fe.step():
        if kill and not killed \
                and engines[1].stats["decode_steps"] >= FLEET["kill_after"]:
            eng.kill(1)
            killed = True
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if kill and not killed:
        fail("[serve fleet] replica 1 was never killed")
    streams = {h.rid: (h.status.value, list(h.tokens)) for h in handles}
    return (streams, eng, wall, launches, [e.stats for e in engines],
            redispatched)


def serve_fleet_phase(model, params):
    """Two replicas of Qwen2-1.5B at full width and depth in fp32 (TF32
    off), sharing one params tree on the card, stepped from a thread each
    by ``ReplicaRouter``: with prefix-affinity routing their streams equal
    one engine's serving the same trace through ``ServeFrontend``, no
    replica down and nothing orphaned; again when replica 1 is killed
    after its 4th decode step (its requests re-dispatched by a prefix hit
    and a walk, none failed, the kill the only replica down); and again
    under least-loaded routing without caches, whose survivor re-prefills
    every orphan through ``flash_attention``. Both attention kernels'
    launches are exact over the two threads; the top-1 minus top-2 logit
    of each re-dispatched first token is printed, on the path the
    survivor took. Returns {path: launches}."""
    import traceback
    from repro_torch.interop import map_tree
    from repro_torch.models import build_model
    from repro_torch.serve import synthetic_trace
    tag = "serve fleet"
    cfg = model.cfg.replace(dtype="float32")
    m32 = build_model(cfg)
    p32 = map_tree(lambda t: t.float(), params)
    trace = synthetic_trace(FLEET["n"], cfg.vocab_size, seed=0,
                            prompt_range=FLEET["prompt_range"],
                            gen_range=FLEET["gen_range"],
                            prefix_len=FLEET["prefix_len"])
    tokens = sum(r.gen for r in trace)
    ref, _, wall1, _, _, _ = fleet_run(m32, p32, trace, 1)
    out = {}
    for name, route, kill in (("fleet", "prefix-affinity", False),
                              ("fleet kill", "prefix-affinity", True),
                              ("fleet kill least-loaded", "least-loaded",
                               True)):
        streams, router, wall, launches, stats, redisp = fleet_run(
            m32, p32, trace, 2, route, kill)
        rs = dict(router.rstats)
        step_ms = [round(1e3 * st["decode_s"] / max(1, st["decode_steps"]),
                         2) for st in stats]
        print(f"[{tag}] {name}: {wall:.3f} s, {tokens / wall:.1f} tok/s "
              f"against one engine's {tokens / wall1:.1f} tok/s "
              f"({wall1:.3f} s); ms per decode step by replica {step_ms} "
              f"(one card's default stream and the GIL are shared, so "
              f"each includes the other's work); router {rs}; replica "
              f"prefix caches {router.prefix_stats()}; launches {launches}")
        raised = [r.error for r in router.replicas]
        for i, e in enumerate(raised):
            if e is not None:
                print(f"[{tag}] {name}: replica {i} went down on "
                      + "".join(traceback.format_exception(e)))
        down, orphaned = rs.get("replicas_down", 0), rs.get("orphaned", 0)
        if any(raised) or down != int(kill) or (orphaned > 0) != kill:
            fail(f"{tag}: {name}: {down} replicas down and {orphaned} "
                 f"orphaned where the run killed {int(kill)}, and "
                 f"{sum(e is not None for e in raised)} raised")
        check_attention_launches(tag, launches, cfg.n_layers, stats)
        same = streams == ref
        print(f"[{tag}] {name}: streams of {len(streams)} requests "
              f"{'identical to' if same else 'DIFFERENT from'} one engine's")
        if not same:
            fail(f"{tag}: {name} streams differ from one engine's")
        if kill:
            print(f"[{tag}] {name}: re-dispatches (rid, tokens delivered, "
                  f"the survivor's path to its first token, that token's "
                  f"top-1 minus top-2 logit): {redisp}; smallest margin "
                  f"{min(m for *_, m in redisp):.4e}")
            if not (orphaned == rs.get("redispatches", 0) == len(redisp) > 0
                    and rs.get("failed", 0) == 0):
                fail(f"{tag}: the kill did not re-dispatch every orphan")
        if route == "least-loaded":
            prefills = sum(attention_calls(st)[0] for st in stats)
            walks = sum(st.get("walk_steps", 0) for st in stats)
            print(f"[{tag}] {name}: {prefills} prefills == {FLEET['n']} "
                  f"admits + {len(redisp)} re-prefills, {walks} walk steps")
            if prefills != FLEET["n"] + len(redisp) or walks \
                    or any(path != "prefill" for _, _, path, _ in redisp):
                fail(f"{tag}: {name}: a re-dispatch did not re-prefill")
        out["serve_" + name.replace(" ", "_").replace("-", "_")] = launches
    return out


# ---------------------------------------------------------------------------
# LM pruning (Qwen2-1.5B class-2 attention + GLU MLP, RWKV6-3B channel mix)
# ---------------------------------------------------------------------------

# 128 calibration sequences of 512 tokens: at 32 (16,384 tokens for 4,480
# kept channels a layer) the ridge overfits, and the compensated Qwen2 is
# further from the dense model on held-out tokens than plain pruning; the
# JAX package does the same at that ratio (tests/lm_overfit_witness.py)
LM = dict(sparsity=0.5, seqs=128, seq=512, batch=8, held=4)
# the kernels' shapes on these paths: Qwen2-1.5B's stacked MLP tap (layers,
# 8 x 512 tokens, d_ff); its causal GQA calibration forward (B, T, H, Hkv,
# d); RWKV6-3B's prefill (B, T, H, N); pruned Qwen2 decode (B, S, H, Hkv,
# dq, dv)
LM_SHAPES = dict(gram=(28, 4096, 8960), attn=(8, 512, 12, 2, 128),
                 wkv=(8, 512, 40, 64), decode=(8, 1024, 12, 2, 64, 128))
# 8 requests; the checkpoint overwrites every drawn leaf
PRUNED_SERVE = ["--arch", "qwen2-1.5b", "--sparsity", "0.5", "--trace",
                "8"] + SERVE_BASE[4:]
# gemma3-1b: sequences longer than its 512-token window, which masks
# nothing at T <= 512 (64 x 1024 = 65,536 calibration tokens, Qwen2's
# 128 x 512)
GEMMA = dict(sparsity=0.5, seqs=64, seq=1024, batch=4, held=2)
GEMMA_SERVE = ["--arch", "gemma3-1b", "--trace", "16", "--slots", "8",
               "--max-len", "2048", "--prompt-range", "256,1536",
               "--gen-range", "32,256", "--init-on-device"]
GEMMA_PRUNED_SERVE = GEMMA_SERVE[:2] + ["--sparsity", "0.5", "--trace",
                                        "8"] + GEMMA_SERVE[4:]



# [serve sharded]: four gloo ranks share the card in one launch: Qwen2-1.5B
# at full width and depth as 2 data x 2 model, RWKV6-3B at full width and
# 8 of its 32 layers as 1 x 4 (the model axis alone; its gates hold at any
# depth, and 32 layers took 390-450 ms a step), seamless-m4t-large-v2 at
# full width and depth as 2 x 2 (each request with 512 frames of its own,
# which travel with its prefill to the data index that holds its slot),
# qwen3-moe-235b-a22b at full width and 1 of its 94 layers as 1 x 4 (32
# experts and one kv head a rank; at 2 layers the single-device reference
# beside the ranks would not fit the card), deepseek-v3-671b at full width
# and 1 of its 61 layers as 2 x 2 (layer 0, dense: MLA over 64 of its 128
# heads a rank with its latent cache split on its dims, and the 18432-wide
# MLP; an MoE layer is 45 GB in fp32), and jamba-1.5-large-398b at full
# width and 1 of its 72 layers as 1 x 4 (layer 0: the Mamba mixer at 4096
# of its 16384 inner channels a rank, and the dense 24576-wide MLP; layer 1
# would be a 38.7 GB MoE layer), fp32, 8 requests through the front-end
# each; ranks that share the card reduce through shared memory
# (serve.sharding.shares_card; a gloo collective between them costs
# 0.9-13 ms, PERF.md §5), and the first request's prefill is run once more
# over the model group's gloo collectives. The serve CLI's --serve-sharded
# beside them (bf16, short requests, its weights drawn on the host and
# only each rank's blocks placed on the card). A case may set its own
# prompts, generations, max_len, mem_len and n_layers
SERVE_SHARDED = dict(
    cases=(dict(tag="qwen2", arch="qwen2-1.5b", mesh=(2, 2),
                kernels=("flash_attention", "flash_decode")),
           dict(tag="rwkv", arch="rwkv6-3b", mesh=(1, 4), n_layers=8,
                kernels=("wkv6",)),
           dict(tag="seamless", arch="seamless-m4t-large-v2", mesh=(2, 2),
                kernels=("flash_attention", "flash_decode"), mem_len=512,
                prompts=(4, 32), gens=(16, 32), max_len=64),
           dict(tag="moe", arch="qwen3-moe-235b-a22b", mesh=(1, 4),
                kernels=("flash_attention", "flash_decode"), n_layers=1),
           dict(tag="mla", arch="deepseek-v3-671b", mesh=(2, 2), n_layers=1,
                kernels=("flash_attention",)),
           dict(tag="mamba", arch="jamba-1.5-large-398b", mesh=(1, 4),
                n_layers=1, kernels=())),
    requests=8, prompts=(64, 256), gens=(16, 32), slots=8, max_len=320,
    seed=5, tol=1e-4)
SERVE_SHARDED_CLI = ["--arch", "qwen2-1.5b", "--trace", "4",
                     "--serve-sharded", "--mesh-shape", "2x2",
                     "--dist-backend", "gloo", "--prompt-range", "8,24",
                     "--gen-range", "4,12"]
# the caching allocator may keep, past a block's bytes, under this much of
# its segment's rounding with it (a block of 10 MB or more takes a segment
# rounded to 2 MiB and keeps a remainder of 1 MiB or less): a rank's set-up
# is held to its blocks plus this much a leaf
LEAF_SLACK = 1 << 20


def spec_bytes(params, specs, sizes):
    """Bytes of a rank's blocks of ``params`` by ``specs``, from the whole
    leaves' sizes: each over the product of the axis sizes it is split
    over."""
    from repro_torch.interop import flatten
    sp = flatten(specs)
    total = 0
    for path, t in flatten(params).items():
        den = math.prod(sizes[a] for a in sp[path] if a is not None)
        total += t.numel() * t.element_size() // den
    return total


def sharded_case_setup(case):
    """A ``SERVE_SHARDED`` case's config (fp32, its depth), trace and
    max_len."""
    from repro_torch.configs import resolve_config
    from repro_torch.serve import synthetic_trace
    S = SERVE_SHARDED
    cfg = resolve_config(case["arch"]).replace(dtype="float32")
    if "n_layers" in case:
        # the layout unrolls every first_k_dense layer whatever n_layers
        # says: a cut below them keeps as many
        cfg = cfg.replace(n_layers=case["n_layers"], first_k_dense=min(
            cfg.first_k_dense, case["n_layers"]))
    trace = synthetic_trace(S["requests"], cfg.vocab_size, seed=S["seed"],
                            prompt_range=case.get("prompts", S["prompts"]),
                            gen_range=case.get("gens", S["gens"]),
                            mem_len=case.get("mem_len"), d_model=cfg.d_model)
    return cfg, trace, case.get("max_len", S["max_len"])


def first_batch(req, device):
    """A request's prefill batch (its frames too, for an enc-dec)."""
    import torch
    batch = {"tokens": torch.from_numpy(req.tokens[None]).to(device)}
    if req.frames is not None:
        batch["frames"] = torch.from_numpy(req.frames[None]).to(device)
    return batch


def _drive(eng, sharding, fn):
    """Run ``fn`` on the lead, which posts its device operations, while
    the other ranks follow them; then release them."""
    if sharding.lead:
        fn()
        eng.stop()
    else:
        eng.follow()


def serve_sharded_case(device, case):
    """One case of ``serve_sharded_rank`` on this rank; returns its
    record."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distrib.sharding import param_specs
    from repro_torch.interop import flatten
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import TensorParallel
    from repro_torch.serve import Request, ServeFrontend, cache_bytes
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.sharding import (ServeSharding,
                                            device_bytes_estimate)
    S = SERVE_SHARDED
    t_case = time.time()
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg, trace, max_len = sharded_case_setup(case)
    model = build_model(cfg)
    sh = ServeSharding(make_mesh(case["mesh"], device_type=device.type))
    t0 = time.time()
    # the single-device engine's weights, drawn on the card (a host draw of
    # 3 G values takes ~30 s a rank), one whole tree at a time; the serve
    # CLI draws on the host and places only the blocks
    for r in range(world):
        if r == rank:
            full = model.init(torch.Generator(device=device).manual_seed(0),
                              device=device)
            blocks = sh.take_params(full)
            # JAX's rule, whose per-rank element counts forward_specs keeps
            want_params = spec_bytes(full, param_specs(full, sh.sizes),
                                     sh.sizes)
            del full
            torch.cuda.empty_cache()
        dist.barrier(group=sh.control)
    rec = {"rank": rank, "coords": sh.coords, "draw_s": time.time() - t0,
           "transport": sh.transport, "layers": cfg.n_layers,
           "enc_layers": cfg.n_enc_layers}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, blocks, n_slots=S["slots"], max_len=max_len,
                      sharding=sh, mem_len=case.get("mem_len"))
    del blocks
    sc = eng.slotcache
    rec.update(param_bytes=cache_bytes(eng.params), want_params=want_params,
               cache_bytes=cache_bytes(sc.cache),
               blank_bytes=cache_bytes(sc._blank),
               cache_leaves=len(flatten(sc.cache)) + len(flatten(sc._blank)),
               param_leaves=len(flatten(eng.params)),
               cache_peak=eng.rank_setup_peak[rank] - base,
               want_cache=device_bytes_estimate(sc._meta, sc.specs, sh),
               unsharded_cache=eng.cache_bytes)
    frames = None if trace[0].frames is None \
        else np.zeros_like(trace[0].frames)

    def warm():     # one 9-token request: a prefill, a walk, a step
        eng.begin()
        eng.admit(Request(rid=-1, tokens=np.zeros(9, np.int32), gen=2,
                          frames=frames), 0)
        eng.decode_step()
        eng.retire(0)
        eng.reset()
    _drive(eng, sh, warm)
    torch.cuda.synchronize()
    reset_launches()
    colls = [tp for tp in (eng.tp, sh.rows) if tp is not None]
    for tp in colls:            # the collectives' seconds, after a sync
        tp.timed = True
    dist.barrier(group=sh.control)

    def serve():
        posted, post = [], sh.post

        def log_post(op, slot=-1, *args):     # each device operation
            posted.append((op, sc.owner(slot) if slot >= 0 else -1))
            return post(op, slot, *args)
        sh.post = log_post
        t1 = time.time()
        handles = ServeFrontend(eng, queue_depth=len(trace)).run(trace)
        rec["trace_s"] = time.time() - t1
        sh.post = post
        rec["posted"] = posted
        rec["streams"] = {h.rid: [int(t) for t in h.tokens]
                          for h in handles}
        rec["stats"] = dict(eng.stats)
    _drive(eng, sh, serve)
    torch.cuda.synchronize()
    rec["launches"] = read_launches()
    rec["coll_s"] = sum(tp.coll_s for tp in colls)
    rec["colls"] = sum(tp.calls for tp in colls)
    for tp in colls:
        tp.timed = False
    # the first request's prefill logits, the rank's vocab blocks gathered:
    # through the shared memory the engine took, and through the model
    # group's gloo collectives (the transport of ranks on cards of their
    # own), on the card
    batch = first_batch(trace[0], device)
    group = TensorParallel(sh.model_group, sh.model_index, sh.model_size)
    for key, tp in (("logits", eng.tp), ("logits_group", group)):
        t1 = time.time()
        logits, _ = model.prefill(eng.params, batch, max_len, tp=tp)
        rec[key] = tp.all_gather(logits[:, -1], -1)[0].cpu()
        torch.cuda.synchronize()
        rec[key + "_s"] = time.time() - t1
    del eng
    torch.cuda.empty_cache()
    rec["case_s"] = time.time() - t_case
    return rec


def serve_sharded_rank(device, out_dir):
    """One rank of ``[serve sharded]``: each case of ``SERVE_SHARDED`` on
    the four ranks (a mesh a case): the rank cuts its blocks of the seeded
    weights (drawn on the card, one rank at a time), the lead serves the
    trace through the front-end while the others follow, its kernels'
    launches are counted and its collectives timed from the trace's start
    to its end, and the first request's prefill logits are gathered.
    Writes ``rank<r>.pt`` for the phase to gate."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs = {case["tag"]: serve_sharded_case(device, case)
            for case in SERVE_SHARDED["cases"]}
    torch.save(recs, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


class RouteCounter:
    """Routed MoE's groups and dropped (token, k) pairs by group size,
    counted while installed (a wrapper of ``models.mlp._route``):
    ``{tg: [groups, dropped]}``."""

    def __init__(self):
        from repro_torch.models import mlp
        self.mlp, self.route, self.by_size = mlp, mlp._route, {}

    def __enter__(self):
        def route(xg, router, cfg):
            out = self.route(xg, router, cfg)
            n = self.by_size.setdefault(int(xg.shape[1]), [0, 0])
            n[0] += xg.shape[0]
            n[1] += int((~out[3]).sum())
            return out
        self.mlp._route = route
        return self

    def __exit__(self, *exc):
        self.mlp._route = self.route
        return False


def serve_sharded_reference(dev, case):
    """The single-device engine on the same seeded weights and trace:
    its streams, the first request's prefill logits and, for routed MoE,
    the groups and dropped pairs of the trace by group size."""
    import torch
    from repro_torch.configs import resolve_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeFrontend
    from repro_torch.serve.engine import ServeEngine
    S = SERVE_SHARDED
    cfg, trace, max_len = sharded_case_setup(case)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    eng = ServeEngine(model, params, n_slots=S["slots"], max_len=max_len,
                      mem_len=case.get("mem_len"))
    eng.warmup(prompt_lens=[len(r.tokens) for r in trace])
    t0 = time.time()
    with RouteCounter() as routed:
        handles = ServeFrontend(eng, queue_depth=len(trace)).run(trace)
    wall = time.time() - t0
    logits = model.prefill(params, first_batch(trace[0], dev), max_len)[0]
    out = {"streams": {h.rid: [int(t) for t in h.tokens] for h in handles},
           "logits": logits[0, -1].cpu(), "trace_s": wall,
           "step_ms": 1e3 * eng.stats["decode_s"]
           / max(1, eng.stats["decode_steps"]), "routed": routed.by_size,
           "depth": f"{cfg.n_layers} of "
           f"{resolve_config(case['arch']).n_layers} decoder layers"}
    del eng, params, logits
    torch.cuda.empty_cache()
    return out


def serve_sharded_kernels(dev):
    """The three kernels of the path against their plain versions at the
    shapes a rank gives them: Qwen2's 6/1 heads a rank (a 256-token
    prefill, 8 slots of decode over 320 rows), RWKV's 10 heads a rank at
    m = 4 and 20 at m = 2 (a 248-token prefill, 8 slots of decode),
    seamless's 8 heads of 64 a rank at 2 x 2 (the encoder over 512 frames,
    a 32-row decoder prefill causal and against the memory, and 4 slots of
    decode over 64 self rows and the 512 memory rows), qwen3-moe's 16/1
    heads a rank at 1 x 4 (a 256-token prefill, 8 slots over 320 rows),
    deepseek-v3's MLA prefill over 64 of its 128 heads a rank at 2 x 2
    (a 256-token prefill, q/k 192 = nope 128 + rope 64 against v 128,
    scale 1/sqrt(192)); jamba's Mamba layer runs no kernel."""
    import torch
    g = torch.Generator(device=dev).manual_seed(25)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    q, k, v = randn(1, 256, 6, 128), randn(1, 256, 1, 128), \
        randn(1, 256, 1, 128)
    check_attention(q, k, v, True, None, 128 ** -0.5, "rank 6/1 T 256")
    S = SERVE_SHARDED["max_len"]
    lens = torch.tensor([64 + 30 * i for i in range(8)], device=dev)
    valid = torch.arange(S, device=dev)[None] < lens[:, None]
    check_decode(randn(8, 6, 128), randn(8, S, 1, 128), randn(8, S, 1, 128),
                 valid, "rank 6/1 8 slots", 1e-4)
    for H in (10, 20):
        for B, T, state in ((1, 248, None), (8, 1, randn(8, H, 64, 64))):
            r, kk, vv = (randn(B, T, H, 64) for _ in range(3))
            w = 0.35 + 0.6 * torch.sigmoid(randn(B, T, H, 64))
            check_wkv6(r, kk, vv, w, 0.1 * randn(H, 64), state,
                       f"rank {H} heads T {T}")
    mem = randn(1, 512, 8, 64), randn(1, 512, 8, 64)
    check_attention(randn(1, 512, 8, 64), *mem, False, None, 0.125,
                    "seamless enc 8 a rank")
    q = randn(1, 32, 8, 64)
    check_attention(q, randn(1, 32, 8, 64), randn(1, 32, 8, 64), True,
                    None, 0.125, "seamless self 8 a rank")
    check_attention(q, *mem, False, None, 0.125, "seamless cross 8")
    lens = torch.tensor([5 + 15 * i for i in range(4)], device=dev)
    valid = torch.arange(64, device=dev)[None] < lens[:, None]
    check_decode(randn(4, 8, 64), randn(4, 64, 8, 64), randn(4, 64, 8, 64),
                 valid, "seamless self 4 slots", 1e-4)
    check_decode(randn(4, 8, 64), randn(4, 512, 8, 64),
                 randn(4, 512, 8, 64),
                 torch.ones(4, 512, dtype=torch.bool, device=dev),
                 "seamless cross 4 slots", 1e-4)
    check_attention(randn(1, 256, 16, 128), randn(1, 256, 1, 128),
                    randn(1, 256, 1, 128), True, None, 128 ** -0.5,
                    "moe rank 16/1 T 256")
    lens = torch.tensor([64 + 30 * i for i in range(8)], device=dev)
    valid = torch.arange(S, device=dev)[None] < lens[:, None]
    check_decode(randn(8, 16, 128), randn(8, S, 1, 128),
                 randn(8, S, 1, 128), valid, "moe rank 16/1 8 slots", 1e-4)
    check_attention(randn(1, 256, 64, 192), randn(1, 256, 64, 192),
                    randn(1, 256, 64, 128), True, None, 192 ** -0.5,
                    "mla rank 64 T 256")


def serve_sharded_phase(dev):
    """``[serve sharded]``: (d) ``--mesh-shape 1x4`` on Qwen2-1.5B (2 kv
    heads) refused before any weights load; then (c) the serve CLI's
    ``--serve-sharded --mesh-shape 2x2 --dist-backend gloo`` as a
    subprocess and (a, b) the four ranks of ``serve_sharded_rank`` from a
    thread, while this thread runs the single-device engine for each case
    (its streams and first logits) and the kernels at a rank's shapes.
    Gates: streams token-identical to the
    single-device engine's, first-step logits within 1e-4 (relative
    Frobenius) through shared memory and through the model group's gloo
    collectives, each rank's cache bytes equal to
    ``device_bytes_estimate`` and its parameter bytes to the sum of its
    blocks by ``param_specs`` (JAX's rule), its cache built within its
    blocks and one empty slot, its ranks on shared memory, each kernel's
    exact launches on each rank (layers times the prefills and walk steps
    of its data index' slots and the decode steps), the CLI's run done
    with its per-device line and each CLI rank's set-up peak on the card
    within its blocks. The cases: Qwen2-1.5B 2 x 2, RWKV6-3B at 8 layers
    1 x 4, seamless-m4t-large-v2 2 x 2 (its frames posted with each
    prefill), qwen3-moe-235b-a22b at 1 layer 1 x 4 (experts over the model
    axis; the single device's capacity drops printed), deepseek-v3-671b
    at 1 layer 2 x 2 (MLA over heads, its latent cache split on its dims)
    and jamba-1.5-large-398b at 1 layer 1 x 4 (the Mamba mixer over its
    inner channels, no kernel). Times are of four ranks on
    one card: they say nothing of scaling. Returns each case's trace
    launches, summed over the ranks, as ``{"serve_sharded_<tag>":
    launches}``."""
    import shutil
    import torch
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.mesh import launch
    from repro_torch.serve.errors import msg
    S = SERVE_SHARDED
    t0, before = time.time(), torch.cuda.memory_allocated()
    refused = None
    try:
        serve_cli.main(SERVE_SHARDED_CLI[:4] + [
            "--serve-sharded", "--mesh-shape", "1x4", "--dist-backend",
            "gloo"])
    except ValueError as e:
        refused = str(e)
    want = msg("shard_ineligible", name="qwen2-1.5b", leaf="k", m=4)
    print(f"[serve sharded] --mesh-shape 1x4 on qwen2-1.5b: {refused!r} in "
          f"{time.time() - t0:.3f} s, {torch.cuda.memory_allocated() - before}"
          f" B allocated")
    if refused != want or torch.cuda.memory_allocated() != before:
        fail("[serve sharded] a 1x4 mesh on Qwen2-1.5B was not refused "
             "before its weights loaded")
    out_dir = OUT + "_serve_sharded"
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    print(f"[serve sharded] python -m repro_torch.launch.serve "
          f"{' '.join(SERVE_SHARDED_CLI)}, beside the engine's ranks")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t1 = time.time()
    cli = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve",
                            *SERVE_SHARDED_CLI], env=env, cwd=ROOT,
                           text=True, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE)
    done = {}

    def drain():
        done["out"], done["err"] = cli.communicate()
        done["wall"] = time.time() - t1
    reader = threading.Thread(target=drain)
    reader.start()
    ranks = {}

    def run_ranks():
        try:
            launch(serve_sharded_rank, 4, backend="gloo", device=dev.type,
                   args=(out_dir,))
        except BaseException as e:      # re-raised below, in this thread
            ranks["error"] = e
        ranks["wall"] = time.time() - t1
    runner = threading.Thread(target=run_ranks)
    runner.start()
    refs = {}
    try:
        # the single-device references and the kernels at a rank's shapes
        # run here while the ranks start and serve
        for case in S["cases"]:
            t2 = time.time()
            refs[case["tag"]] = serve_sharded_reference(dev, case)
            print(f"[serve sharded] {case['arch']} single device, fp32, "
                  f"{refs[case['tag']]['depth']} (run beside the ranks): "
                  f"trace "
                  f"{refs[case['tag']]['trace_s']:.3f} s, "
                  f"{refs[case['tag']]['step_ms']:.2f} ms a decode step; "
                  f"reference wall {time.time() - t2:.3f} s")
        serve_sharded_kernels(dev)
        torch.cuda.empty_cache()
    finally:
        runner.join()
        reader.join(timeout=600)
        if cli.poll() is None:
            cli.kill()
        reader.join()
    if "error" in ranks:
        raise ranks["error"]
    wall = ranks["wall"]
    recs = [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(4)]
    launches = {}
    for case in S["cases"]:
        tag, ref = case["tag"], refs[case["tag"]]
        lead = recs[0][tag]
        err = rel_err(lead["logits"].float(), ref["logits"].float())
        same = lead["streams"] == ref["streams"]
        st = lead["stats"]
        prefills = sum(v for k, v in st.items() if k.startswith("prefill_b"))
        print(f"[serve sharded] {case['arch']} fp32 on a {case['mesh']} "
              f"(data x model) mesh of 4 gloo ranks on one card, "
              f"model-axis collectives through shared memory, each timed "
              f"after a device sync: trace {lead['trace_s']:.3f} s, "
              f"{1e3 * st['decode_s'] / max(1, st['decode_steps']):.2f} ms "
              f"a decode step ({st['decode_steps']} steps; single device "
              f"{ref['step_ms']:.2f}), "
              f"{1e3 * st['prefill_s'] / max(1, prefills):.2f} ms a prefill,"
              f" {st.get('walk_steps', 0)} walk steps; the "
              f"lead's {lead['colls']} collectives took {lead['coll_s']:.3f}"
              f" s, {100 * lead['coll_s'] / lead['trace_s']:.1f}% of the "
              f"trace; streams equal to the single device's: {same}; "
              f"first-step logits relative error {err:.3e} (tol "
              f"{S['tol']:g})")
        if not same:
            fail(f"[serve sharded] {tag}: streams differ from the single "
                 f"device's")
        if not err <= S["tol"]:
            fail(f"[serve sharded] {tag}: first-step logits {err:.3e} from "
                 f"the single device's")
        err_g = rel_err(lead["logits_group"].float(), ref["logits"].float())
        gap = (lead["logits_group"] - lead["logits"]).abs().max().item()
        print(f"[serve sharded] {tag} first-request prefill over the model "
              f"group's gloo collectives: {lead['logits_group_s']:.3f} s "
              f"(shared memory {lead['logits_s']:.3f}), logits relative "
              f"error {err_g:.3e}, max gap to shared memory's {gap:.3e}")
        if not err_g <= S["tol"]:
            fail(f"[serve sharded] {tag}: the gloo group's first-step "
                 f"logits {err_g:.3e} from the single device's")
        steps = max(1, st["decode_steps"])
        print(f"[serve sharded] {tag} collectives a decode step, by rank "
              f"(calls, ms; prefills' and walks' included): " + ", ".join(
                  f"{r}: {rec[tag]['colls'] / steps:.1f}, "
                  f"{1e3 * rec[tag]['coll_s'] / steps:.2f}"
                  for r, rec in enumerate(recs)))
        if ref["routed"]:
            # the single device's routing groups and dropped (token, k)
            # pairs by group size: a prefill's group is its bucket
            print(f"[serve sharded] {tag} single device, routed MoE groups "
                  f"and dropped pairs by group size: " + ", ".join(
                      f"{tg} tokens: {n} groups, {k} dropped" for tg, (n, k)
                      in sorted(ref["routed"].items())))
        # each rank's exact launches: a layer's kernel in every prefill and
        # walk step of the slots its data index holds, and in every decode
        # step; an enc-dec prefill runs the encoder's layers and the
        # decoder's self and cross attention, its decode step self and
        # cross
        ops = collections.Counter(lead["posted"])
        for r, rec in enumerate(recs):
            rec = rec[tag]
            d, L = rec["coords"].get("data", 0), rec["layers"]
            pre, walk = ops[("prefill", d)], ops[("walk", d)]
            dec = sum(n for (op, _), n in ops.items() if op == "decode")
            want = {k: 0 for k in rec["launches"] if " " not in k}
            kernels = case["kernels"]
            if "wkv6" in kernels:
                want["wkv6"] = L * (pre + walk + dec)
            elif rec["enc_layers"]:
                want.update(flash_attention=(rec["enc_layers"] + 2 * L) * pre,
                            flash_decode=2 * L * (walk + dec))
            else:   # MLA decodes plain from its latent; Mamba runs no kernel
                if "flash_attention" in kernels:
                    want["flash_attention"] = L * pre
                if "flash_decode" in kernels:
                    want["flash_decode"] = L * (walk + dec)
            got = {k: rec["launches"][k] for k in want}
            print(f"[serve sharded] {tag} rank {r} {rec['coords']} "
                  f"({rec['transport']} collectives): params "
                  f"{rec['param_bytes']} B (JAX's spec blocks "
                  f"{rec['want_params']}), cache {rec['cache_bytes']} B "
                  f"(estimate {rec['want_cache']}, unsharded "
                  f"{rec['unsharded_cache']}), the cache's set-up peak "
                  f"{rec['cache_peak']} B (blocks and one empty slot "
                  f"{rec['cache_bytes'] + rec['blank_bytes']}), draw and "
                  f"cut {rec['draw_s']:.3f} s, case {rec['case_s']:.3f} s, "
                  f"launches {got} ({pre} "
                  f"prefills, {walk} walk steps, {dec} decode steps)")
            if rec["param_bytes"] != rec["want_params"] \
                    or rec["cache_bytes"] != rec["want_cache"]:
                fail(f"[serve sharded] {tag} rank {r}: bytes off its specs")
            if rec["cache_peak"] > rec["cache_bytes"] + rec["blank_bytes"] \
                    + rec["cache_leaves"] * LEAF_SLACK:
                fail(f"[serve sharded] {tag} rank {r}: building the cache "
                     f"took more than its blocks")
            if rec["transport"] != "host":
                fail(f"[serve sharded] {tag} rank {r}: ranks sharing the "
                     f"card did not reduce through shared memory")
            if got != want:
                fail(f"[serve sharded] {tag} rank {r}: launches {got}, "
                     f"want {want}")
            mine = launches.setdefault(f"serve_sharded_{tag}", {})
            for k, n in rec["launches"].items():
                mine[k] = mine.get(k, 0) + n
    print("\n".join("  " + ln for ln in done["out"].splitlines()))
    if cli.returncode != 0:
        print(done["err"][-4000:], file=sys.stderr)
        fail(f"[serve sharded] the sharded serve CLI exited {cli.returncode}")
    row = [ln for ln in done["out"].splitlines() if ln.startswith("| front")]
    if "sharded over {'data': 2, 'model': 2}: per-device cache" \
            not in done["out"] or not row \
            or row[0].split("|")[3].strip() != "4":
        fail("[serve sharded] the CLI did not serve its 4 requests sharded")
    # each CLI rank drew on the host and placed only its blocks: its card's
    # peak over the set-up stays within its parameter and cache blocks, one
    # empty slot's (at most the cache again) and the allocator's rounding
    # (the engine's Qwen2 ranks hold the same leaves)
    q = recs[0]["qwen2"]
    slack = (q["param_leaves"] + q["cache_leaves"]) * LEAF_SLACK
    per = re.search(r"\[serve\] per rank \(host collectives\): params "
                    r"\[(.*)\] B, cache \[(.*)\] B; the card's peak over "
                    r"the set-up \[(.*)\] B", done["out"])
    if not per:
        fail("[serve sharded] the CLI printed no per-rank line of host "
             "collectives")
    params_b, cache_b, peak_b = ([int(x) for x in g.split(", ")]
                                 for g in per.groups())
    for r, (p, c, k) in enumerate(zip(params_b, cache_b, peak_b)):
        print(f"[serve sharded] CLI rank {r}: set-up peak {k} B on the "
              f"card, {k - p - c} B past its blocks (params {p} B, cache "
              f"{c} B; bound: the cache again and {slack} B of rounding)")
        if k > p + 2 * c + slack:
            fail(f"[serve sharded] CLI rank {r}: its set-up peak {k} B "
                 f"passes its blocks")
    print(f"[serve sharded] launch wall {wall:.3f} s, CLI wall "
          f"{done['wall']:.3f} s (its ranks beside the engine's on one "
          f"card)")
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches


def zipf_tokens(vocab, n_seqs, seq, seed, dev):
    """The full-vocabulary LM phases' calibration tokens: drawn iid from a
    Zipf-like unigram, p(v) proportional to 1 / (v + 1), by a seeded
    torch.Generator on ``dev``. This stream is the port's own and is not
    held to the JAX package: the reference's generator needs a V x V
    Markov table (92 GB at Qwen2-1.5B's V = 151936), so it runs only on
    reduced vocabularies (the CPU parity tests). On the card the draw is
    not the same in another process from the same seed
    (``tools/moe_tp_routing_probe.py``: four ranks, four streams), so
    ranks that must share a stream draw it on the host."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    p = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float32, device=dev)
    return torch.multinomial(p, n_seqs * seq, replacement=True,
                             generator=g).reshape(n_seqs, seq) \
        .to(torch.int32)


def lm_calib(cfg, dev, seed=11, spec=LM):
    """(zero-arg calibration stream of spec['seqs'] sequences of
    spec['seq'] tokens in batches of spec['batch'], the held-out batch of
    spec['held'] more sequences); ``spec`` is ``LM`` or ``GEMMA``."""
    toks = zipf_tokens(cfg.vocab_size, spec["seqs"], spec["seq"], seed, dev)
    batches = [{"tokens": toks[i:i + spec["batch"]]}
               for i in range(0, spec["seqs"], spec["batch"])]
    held = {"tokens": zipf_tokens(cfg.vocab_size, spec["held"], spec["seq"],
                                  seed + 1, dev)}
    return (lambda: iter(batches)), held


def logits32(cfg, params, batch):
    """Logits of an LM's params evaluated in fp32 (TF32 off): a comparison
    of two pruned models then measures their weights, not the bf16
    rounding of each activation."""
    from repro_torch.interop import map_tree
    from repro_torch.models import build_model
    p32 = map_tree(lambda t: t.float(), params)
    return build_model(cfg.replace(dtype="float32")).apply(p32, batch)[0]


def lm_kernel_phase(dev, rows):
    """Each kernel against its plain version at the shapes LM pruning and
    pruned serving give it, timed beside its bound and one-call PyTorch
    equivalent; the results join the JSON rows of ``kernel_phase``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.flash_decode import ops as decode_ops
    from repro_torch.kernels.flash_decode import ref as decode_ref
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram import ref as gram_ref
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    by_name = {row["name"]: row for row in rows}
    g = torch.Generator(device=dev).manual_seed(5)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    print("[kernels lm prune] each against its plain version at the LM "
          "prune and pruned-serve shapes")
    # gram: Qwen2-1.5B's MLP tap, 28 layers x 8 x 512 tokens x d_ff 8960
    L, N, Fd = LM_SHAPES["gram"]
    gram_rows = {}
    for dt, tol, peak in ((torch.float32, 1e-5, PEAK_FP32_FLOPS),
                          (torch.bfloat16, 1e-2, PEAK_BF16_FLOPS)):
        x = rand(L, N, Fd, dtype=dt)
        err = check_gram(x, tol=tol, label="Qwen2 MLP tap")
        if dt == torch.float32:
            s2 = gram_ops.gram(x)["s2"]
            symmetric = bool(torch.equal(s2, s2.mT))
            print(f"  gram Qwen2 MLP tap {tuple(x.shape)} fp32: s2 equals "
                  f"its transpose bit for bit: "
                  f"{'ok' if symmetric else 'FAIL'}")
            del s2
            if not symmetric:
                fail("gram's s2 is not exactly symmetric at the LM shape")
        r = {"shape": [L, N, Fd], "max_abs_err": err,
             "ms": time_ms(lambda: gram_ops.gram(x), reps=3, warmup=1),
             "plain_ms": time_ms(lambda: gram_ref.gram(x), reps=3,
                                 warmup=1),
             "library_ms": time_ms(lambda: torch.matmul(x.mT, x), reps=3,
                                   warmup=1)}
        r["bound_ms"], r["bound_by"] = bound_ms(
            1.0 * L * N * Fd * (Fd + 1),
            x.element_size() * L * N * Fd + 4.0 * (L * Fd * Fd + L * Fd),
            peak)
        print(f"  gram at the Qwen2 prune shape {tuple(x.shape)} "
              f"{str(dt)[6:]}: kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, torch.matmul {r['library_ms']:.3f} "
              f"ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
        gram_rows[str(dt)[6:]] = r
        del x
        torch.cuda.empty_cache()
    by_name["gram"]["lm_prune"] = gram_rows

    # flash_attention: the Qwen2 calibration forward, causal GQA 12/2
    B, T, H, Hkv, d = LM_SHAPES["attn"]
    bf = torch.bfloat16
    q, k, v = rand(B, T, H, d, dtype=bf), rand(B, T, Hkv, d, dtype=bf), \
        rand(B, T, Hkv, d, dtype=bf)
    scale = 1.0 / math.sqrt(d)
    err = check_attention(q, k, v, True, None, scale,
                          f"Qwen2 calib B={B} T={T} bf16", tol=2e-2)
    qt = q.transpose(1, 2)
    kt, vt = (a.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
              for a in (k, v))
    calls = {"ms": lambda: flash_ops.attention(q, k, v, causal=True,
                                               scale=scale),
             "plain_ms": lambda: flash_ref.attention(q, k, v, causal=True,
                                                     scale=scale),
             "library_ms": lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, scale=scale)}
    fa = {"shape": [B, T, H, Hkv, d], "max_abs_err": err,
          **{key: device_ms(fn, reps=10) for key, fn in calls.items()}}
    fa["bound_ms"], fa["bound_by"] = bound_ms(
        2.0 * B * H * (T * (T + 1) / 2) * 2 * d,
        2.0 * B * T * (2 * H + 2 * Hkv) * d, PEAK_BF16_FLOPS)
    print(f"  flash_attention at the Qwen2 calibration shape B={B} T={T} "
          f"H={H}/{Hkv} d={d} causal bf16, device time: kernel "
          f"{fa['ms']:.4f} ms, plain {fa['plain_ms']:.4f} ms, SDPA "
          f"{fa['library_ms']:.4f} ms, bound {fa['bound_ms']:.4f} ms "
          f"({fa['bound_by']})")
    by_name["flash_attention"]["lm_calib"] = fa
    del q, k, v, qt, kt, vt

    # wkv6: the RWKV calibration forward, prefill B 8, T 512, no state
    B, T, H, Nh = LM_SHAPES["wkv"]

    def wrand(*shape):
        return torch.randn(shape, generator=g, device=dev)
    r, kk, vv = (wrand(B, T, H, Nh).to(bf) for _ in range(3))
    w = torch.exp(-torch.exp(-2.0 + 0.5 * wrand(B, T, H, Nh))).to(bf)
    u = 0.1 * wrand(H, Nh)
    err_y, err_s = check_wkv6(r, kk, vv, w, u, None,
                              f"RWKV calib B={B} T={T}")
    wk = {"shape": [B, T, H, Nh], "max_abs_err": err_y,
          "max_abs_err_state": err_s,
          "blocks": wkv_ops.Plan(B, T, H, Nh).blocks,
          "ms": device_ms(lambda: wkv_ops.wkv6(r, kk, vv, w, u, None),
                          reps=10),
          "plain_ms": device_ms(lambda: wkv_ref.wkv6(r, kk, vv, w, u, None),
                                reps=1, replays=1, warmup=1),
          "library_ms": None}
    wk["bound_ms"], wk["bound_by"] = bound_ms(
        wkv6_flops(B, T, H, Nh), wkv6_bytes(B, T, H, Nh, 2, False))
    print(f"  wkv6 at the RWKV calibration shape B={B} T={T} H={H} N={Nh} "
          f"bf16 ({wk['blocks']} blocks), device time: kernel "
          f"{wk['ms']:.4f} ms, plain {wk['plain_ms']:.4f} ms, bound "
          f"{wk['bound_ms']:.4f} ms ({wk['bound_by']}); no single PyTorch "
          f"call computes it")
    by_name["wkv6"]["lm_calib"] = wk
    del r, kk, vv, w

    # flash_decode: pruned Qwen2 serving, dq 64, dv 128, the serve mask
    B, S, H, Hkv, dq, dv = LM_SHAPES["decode"]
    q = rand(B, H, dq, dtype=bf)
    k, v = rand(B, S, Hkv, dq, dtype=bf), rand(B, S, Hkv, dv, dtype=bf)
    lens = [128 + 48 * i for i in range(B)]
    vmask = torch.arange(S, device=dev)[None] < torch.tensor(
        lens, device=dev)[:, None]
    scale = 1.0 / math.sqrt(dv)         # the dense logit scale, qk_full
    err = check_decode(q, k, v, vmask, f"pruned dq={dq} serve mask", 2e-2)
    kt, vt = (a.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
              for a in (k, v))
    qt, m4 = q[:, :, None], vmask[:, None, None, :]
    calls = {"ms": lambda: decode_ops.decode_attention(q, k, v, vmask,
                                                       scale=scale),
             "plain_ms": lambda: decode_ref.decode_attention(q, k, v, vmask,
                                                             scale),
             "library_ms": lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=m4, scale=scale)}
    fd = {"shape": [B, S, H, Hkv, dq, dv], "lens": lens, "max_abs_err": err,
          **{key: device_ms(fn) for key, fn in calls.items()}}
    keys = sum(lens)
    fd["bound_ms"], fd["bound_by"] = bound_ms(
        2.0 * H * keys * (dq + dv),
        keys * Hkv * (dq + dv) * 2 + 2 * B * H * (dq + dv) + B * S,
        PEAK_BF16_FLOPS)
    print(f"  flash_decode at the pruned serve mask dq={dq} dv={dv} "
          f"(lengths {lens[0]}..{lens[-1]} of {S}), device time: kernel "
          f"{fd['ms']:.4f} ms, plain {fd['plain_ms']:.4f} ms, SDPA "
          f"{fd['library_ms']:.4f} ms, bound {fd['bound_ms']:.4f} ms "
          f"({fd['bound_by']})")
    by_name["flash_decode"]["pruned_serve_mask"] = fd
    del q, k, v, kt, vt


def lm_prune_run(tag, model, params, calib, held, dense, pc,
                 evaluate=None, **kw):
    """``corp_prune`` of a full-width LM, timed and counted; returns
    (pruned params, pruned config, report, launches, held-out logits
    (``evaluate(cfg, params, batch)``, default fp32: ``logits32``), their
    relative error to the dense logits)."""
    import torch
    from repro_torch.core import corp_prune
    marks = []

    def mark(msg):          # launches so far, at the start of each stage
        marks.append((msg.split(":")[0], read_launches()))
    reset_launches()
    t0 = time.time()
    new, ncfg, rep = corp_prune(model, params, calib, pc, progress=mark,
                                **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    marks.append(("end", launches))
    by_pass = {a: {k: n - before.get(k, 0) for k, n in after.items()
                   if n - before.get(k, 0) and " " not in k}
               for (a, before), (_, after) in zip(marks, marks[1:])
               if a.startswith("pass")}
    check_report(tag, rep)
    logits = (evaluate or logits32)(ncfg, new, held)
    if not bool(torch.isfinite(logits).all()):
        fail(f"{tag}: held-out logits are not finite")
    err = rel_err(logits, dense)
    print(f"[{tag}] wall {wall:.3f} s; stages {stages(rep)}; traversals "
          f"{rep['traversals']}; launches {launches}, by pass {by_pass}; "
          f"d_ff {model.cfg.d_ff} -> {ncfg.eff_d_ff}, qk "
          f"{model.cfg.qk_full} -> {ncfg.eff_qk}; held-out |pruned - dense| "
          f"/ |dense| {'fp32' if evaluate is None else 'bf16'} logits "
          f"{err:.4f}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    return new, ncfg, rep, launches, logits, err


def lm_model(arch, dev):
    """A full-width LM with seeded weights drawn on the card (a CPU
    generator takes tens of seconds for RWKV6-3B's 3.1 G values)."""
    import torch
    from repro_torch.configs import resolve_config
    from repro_torch.models import build_model
    model = build_model(resolve_config(arch))
    return model, model.init(torch.Generator(device=dev).manual_seed(0),
                             device=dev)


def prune_qwen2_phase(dev):
    """CORP of Qwen2-1.5B at full width (seeded bf16 weights, the port-only
    Zipf stream): two-pass, compensated and not, then one traversal at
    margin 1.0 (a sure hit, <= 1e-4 from two-pass) and at the default
    margin (reported). Returns ({path: launches}, the compensated pruned
    params and config)."""
    import torch
    from repro_torch.core import PruneConfig
    model, params = lm_model("qwen2-1.5b", dev)
    calib, held = lm_calib(model.cfg, dev)
    dense = logits32(model.cfg, params, held)
    pc = PruneConfig(LM["sparsity"], LM["sparsity"])
    print(f"[prune qwen2] corp_prune of qwen2-1.5b, {LM['seqs']} sequences "
          f"of {LM['seq']} tokens in batches of {LM['batch']} (port-only "
          f"Zipf stream), sparsity {LM['sparsity']}/{LM['sparsity']}")
    torch.cuda.reset_peak_memory_stats()
    new, ncfg, rep, launches, logits, comp = lm_prune_run(
        "prune qwen2", model, params, calib, held, dense, pc)
    want = (model.cfg.d_ff // 2, model.cfg.qk_full // 2)    # 4480, 64
    if (ncfg.eff_d_ff, ncfg.eff_qk) != want:
        fail(f"prune qwen2: d_ff {ncfg.eff_d_ff}, qk {ncfg.eff_qk}; want "
             f"{want}")
    for name in ("gram", "flash_attention"):
        if launches[name] <= 0:
            fail(f"prune qwen2 never launched {name}")
    out = {"prune_qwen2": launches}
    *_, nocomp = lm_prune_run(
        "prune qwen2 no-compensate", model, params, calib, held, dense,
        PruneConfig(LM["sparsity"], LM["sparsity"], compensate=False))
    print(f"[prune qwen2] held-out fp32 logits, |pruned - dense| / |dense|: "
          f"compensated {comp:.4f}, no-compensate {nocomp:.4f}")
    if not comp < nocomp:
        fail("prune qwen2: the compensated prune is not closer to the dense "
             "model than the uncompensated one")
    for margin, tag in ((1.0, "prune qwen2 one traversal"),
                        (0.25, "prune qwen2 one traversal default margin")):
        _, _, r1, l1, lg1, _ = lm_prune_run(
            tag, model, params, calib, held, dense, pc, one_traversal=True,
            spec_margin=margin)
        sp = r1["speculative"]
        err = rel_err(lg1, logits)
        print(f"[{tag}] margin {margin}: traversals {r1['traversals']}, "
              f"candidates {sp['candidates']}, hits {sp['hits']}, misses "
              f"{sp['misses']}; held-out |one - two-pass| / |two-pass| fp32 "
              f"logits {err:.3e} (tol 1e-4)")
        if margin == 1.0:
            if r1["traversals"] != 1 or sp["misses"]:
                fail(f"{tag}: a full candidate set missed")
            out["prune_qwen2_1trav"] = l1
        if not err <= 1e-4:
            fail(f"{tag}: more than 1e-4 from the two-pass prune")
    del params, dense, logits
    return out, new, ncfg


def prune_rwkv_phase(dev):
    """CORP of RWKV6-3B at full width: channel-mix units only, one
    traversal, compensated (``bv_comp`` in every layer) and not. Returns
    ({path: launches}, the compensated pruned params and config)."""
    import torch
    from repro_torch.core import PruneConfig
    model, params = lm_model("rwkv6-3b", dev)
    calib, held = lm_calib(model.cfg, dev)
    dense = logits32(model.cfg, params, held)
    print(f"[prune rwkv] corp_prune of rwkv6-3b, {LM['seqs']} sequences of "
          f"{LM['seq']} tokens in batches of {LM['batch']} (port-only Zipf "
          f"stream), MLP sparsity {LM['sparsity']}")
    torch.cuda.reset_peak_memory_stats()
    new, ncfg, rep, launches, _, comp = lm_prune_run(
        "prune rwkv", model, params, calib, held, dense,
        PruneConfig(LM["sparsity"], LM["sparsity"]))
    for name in ("gram", "wkv6"):
        if launches[name] <= 0:
            fail(f"prune rwkv never launched {name}")
    bv = new["seg0"]["p0"]["mlp"].get("bv_comp")
    if bv is None or tuple(bv.shape) != (model.cfg.n_layers,
                                         model.cfg.d_model):
        fail("prune rwkv: no bv_comp of (layers, d_model) in the channel "
             "mixes")
    *_, nocomp = lm_prune_run(
        "prune rwkv no-compensate", model, params, calib, held, dense,
        PruneConfig(LM["sparsity"], LM["sparsity"], compensate=False))
    print(f"[prune rwkv] held-out fp32 logits, |pruned - dense| / |dense|: "
          f"compensated {comp:.4f}, no-compensate {nocomp:.4f}; bv_comp "
          f"{tuple(bv.shape)} in every layer, max |bv_comp| "
          f"{float(bv.abs().max()):.3e}")
    if not comp < nocomp:
        fail("prune rwkv: the compensated prune is not closer to the dense "
             "model than the uncompensated one")
    return {"prune_rwkv": launches}, new, ncfg


def save_pruned(tag, params, cfg, name):
    """``save_checkpoint`` of a pruned model under build/; returns its
    directory."""
    import shutil
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.interop import flatten
    ck = f"{OUT}_pruned_{name}"
    shutil.rmtree(ck, ignore_errors=True)
    t0 = time.time()
    save_checkpoint(ck, 0, params, extra={"config": cfg.name})
    n = sum(t.numel() for t in flatten(params).values())
    print(f"[{tag}] saved the pruned {cfg.name} ({n / 1e9:.3f} G params) "
          f"under build/ in {time.time() - t0:.3f} s")
    return ck


def serve_pruned_ckpt(args, tag, ck, cfg, leaf, want):
    """``launch.serve --ckpt-in ck``: every request served, the model the
    pruned config, and its compensation leaf ``leaf`` (a key path) restored
    equal to ``want``. Returns {kernel: launches}."""
    import shutil
    import torch
    from repro_torch.interop import flatten
    launches, res = serve_phase(args + ["--ckpt-in", ck], tag,
                                ("flash_attention", "flash_decode"))
    shutil.rmtree(ck, ignore_errors=True)
    arg = dict(zip(args[::2], args[1::2]))
    got = flatten(res["params"])[leaf]
    if res["model"].cfg != cfg or not torch.equal(got.cpu(), want) \
            or [len(c.tokens) for c in res["completions"]] \
            != [r.gen for r in cli_trace(arg, cfg)]:
        fail(f"{tag}: a request did not complete, or the model is not the "
             f"pruned one with its {leaf}")
    print(f"[{tag}] {leaf} {tuple(got.shape)} restored from the checkpoint")
    return launches


def serve_pruned_phase(dev, qwen, rwkv):
    """The pruned Qwen2-1.5B saved with ``save_checkpoint`` and served by
    the serve CLI through ``--ckpt-in`` (every request completes; its K
    rows are half the dense model's); the pruned RWKV6-3B served through
    the engine in process. Returns {path: launches}."""
    from repro_torch.models import build_model
    from repro_torch.serve import (ServeEngine, cache_bytes, percentile_table,
                                   synthetic_trace)
    out = {}
    params, cfg = qwen
    want = params["seg0"]["p0"]["mlp"]["bd"].cpu()
    ck = save_pruned("serve pruned", params, cfg, "qwen2")
    del params
    out["serve_pruned_qwen2"] = serve_pruned_ckpt(
        PRUNED_SERVE, "serve pruned", ck, cfg, "seg0/p0/mlp/bd", want)
    dense_cfg = cfg.replace(qk_kept=None, d_ff_kept=None)
    slot = {name: cache_bytes(build_model(c).init_cache(1, 1024, "meta"))
            for name, c in (("dense", dense_cfg), ("pruned", cfg))}
    print(f"[serve pruned] slot-cache bytes per slot at max_len 1024: dense "
          f"{slot['dense']}, pruned {slot['pruned']} (K rows dq "
          f"{cfg.qk_full} -> {cfg.eff_qk}, V rows dv {cfg.d_head})")
    if not slot["pruned"] < slot["dense"]:
        fail("serve pruned: the pruned slot cache is not smaller")
    params, cfg = rwkv
    model = build_model(cfg)
    trace = synthetic_trace(8, cfg.vocab_size, seed=0, prompt_range=(64, 256),
                            gen_range=(16, 64))
    eng = ServeEngine(model, params, n_slots=8, max_len=1024)
    eng.warmup(prompt_lens=[len(r.tokens) for r in trace])
    reset_launches()
    t0 = time.time()
    comps = eng.run(trace)
    wall = time.time() - t0
    launches = read_launches()
    table = percentile_table(comps, wall)
    print(f"[serve pruned rwkv] engine in process, 8 requests: "
          f"{table['tokens']} tokens, {table['tok_per_s']:.1f} tok/s, TTFT "
          f"p50/p99 {table['ttft_p50_ms']:.1f}/{table['ttft_p99_ms']:.1f} ms, "
          f"latency p50/p99 {table['lat_p50_ms']:.1f}/"
          f"{table['lat_p99_ms']:.1f} ms; launches {launches}")
    if launches["wkv6"] <= 0 or [len(c.tokens) for c in comps] \
            != [r.gen for r in trace] or not all(
                ((0 <= c.tokens) & (c.tokens < cfg.vocab_size)).all()
                for c in comps):
        fail("serve pruned rwkv: a request did not complete or wkv6 never "
             "launched")
    out["serve_pruned_rwkv"] = launches
    return out


def lm_reference_phase():
    """Both reduced LMs (fp32) through ``launch.prune --calib-seq 16 --out``
    on the GPU and on the CPU: pruned logits within 1e-3; then the GPU's
    checkpoint through ``launch.serve --ckpt-in`` on both: equal token
    streams."""
    import torch
    from repro_torch.launch import prune, serve
    from repro_torch.models import build_model
    for arch in ("qwen2-1.5b-reduced", "rwkv6-3b-reduced"):
        logits = {}
        for device in ("cuda", "cpu"):
            out = f"{OUT}_{arch}_{device}"
            res = prune.main(["--arch", arch, "--sparsity", "0.5",
                              "--calib-seq", "16", "--device", device,
                              "--out", out])
            toks = torch.arange(2 * 24, dtype=torch.int32).reshape(2, 24) \
                % res["pruned_cfg"].vocab_size
            logits[device] = build_model(res["pruned_cfg"]).apply(
                res["pruned_params"],
                {"tokens": toks.to(res["pruned_params"]["embed"].device)}
            )[0].cpu()
        err = rel_err(logits["cuda"], logits["cpu"])
        print(f"[reference lm prune] {arch}: pruned logits GPU vs CPU "
              f"relative error {err:.3e} (tol 1e-3)")
        if not err <= 1e-3:
            fail(f"{arch}: the pruned model on the GPU disagrees with the "
                 f"CPU's plain path")
        streams = {}
        for device in ("cuda", "cpu"):
            res = serve.main(["--arch", arch, "--sparsity", "0.5",
                              "--ckpt-in", f"{OUT}_{arch}_cuda"]
                             + SERVE_REDUCED[2:] + ["--device", device])
            streams[device] = [c.tokens.tolist() for c in res["completions"]]
        same = streams["cuda"] == streams["cpu"]
        print(f"[reference lm prune] {arch} pruned checkpoint served, GPU vs "
              f"CPU streams: {sum(map(len, streams['cuda']))} tokens, "
              f"{'identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"{arch}: the pruned model's streams on the GPU differ from "
                 f"the CPU's")


# ---------------------------------------------------------------------------
# gemma3-1b: qk-norm, the 5:1 window stack and its ring, class-3 pruning
# ---------------------------------------------------------------------------

def visible_keys(T, window):
    """Keys a causal (optionally windowed) query row of each of T positions
    sees, summed over the rows."""
    w = T if window is None else window
    return sum(min(t + 1, w) for t in range(T))


def gemma_kernel_phase(dev, rows):
    """``flash_attention`` and ``flash_decode`` at head dim 256, at the
    shapes gemma3-1b gives them (window 512 and global layers, dense and
    pruned decode against the ring's and the global layers' masks), and
    ``gram`` / ``gram_cross`` at its MLP tap and class-3 speculative
    grams; each against its plain version, timed beside its bound and the
    one-call PyTorch equivalent."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.flash_decode import ops as decode_ops
    from repro_torch.kernels.flash_decode import ref as decode_ref
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram import ref as gram_ref
    by_name = {row["name"]: row for row in rows}
    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    print("[kernels gemma] head dim 256 against the plain versions at the "
          "gemma3-1b shapes")
    # flash_attention: the calibration forward's B 4 x T 1024, GQA 4/1
    for dt, tol, peak, (B, T), cases in (
            (bf, 2e-2, PEAK_BF16_FLOPS, (4, 1024),
             ((512, "gemma_window"), (None, "gemma_global"))),
            (torch.float32, 1e-4, PEAK_FP32_FLOPS, (1, 600),
             ((512, "gemma_fp32_window"),))):
        H, Hkv, d = 4, 1, 256
        q, k, v = rand(B, T, H, d, dtype=dt), rand(B, T, Hkv, d, dtype=dt), \
            rand(B, T, Hkv, d, dtype=dt)
        scale = d ** -0.5
        qt = q.transpose(1, 2)
        kt, vt = (a.transpose(1, 2).repeat_interleave(H, dim=1)
                  for a in (k, v))
        qi = torch.arange(T, device=dev)[:, None]
        ki = torch.arange(T, device=dev)[None, :]
        for window, tag in cases:
            err = check_attention(q, k, v, True, window, scale,
                                  f"{tag} B={B} T={T}", tol=tol)
            mask = (ki <= qi) & (ki > qi - window) if window else None

            def library(mask=mask):
                if mask is None:
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, scale=scale)
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=scale)
            calls = {"ms": lambda w=window: flash_ops.attention(
                         q, k, v, causal=True, window=w, scale=scale),
                     "plain_ms": lambda w=window: flash_ref.attention(
                         q, k, v, causal=True, window=w, scale=scale),
                     "library_ms": library}
            r = {"shape": [B, T, H, Hkv, d], "window": window,
                 "max_abs_err": err,
                 **{key: device_ms(fn, reps=10) for key, fn in
                    calls.items()}}
            r["bound_ms"], r["bound_by"] = bound_ms(
                2.0 * B * H * visible_keys(T, window) * 2 * d,
                q.element_size() * B * T * (2 * H + 2 * Hkv) * d, peak)
            print(f"  flash_attention {tag} B={B} T={T} H={H}/{Hkv} d={d} "
                  f"{str(dt)[6:]}, device time: kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, SDPA "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
            by_name["flash_attention"][tag] = r
        del q, k, v, qt, kt, vt

    # flash_decode: eight serve slots; the ring's mask (S 512: a slot
    # shorter than the window holds a prefix, a longer one every slot) and
    # the global layers' (S 2048, a prefix of the slot's length)
    B, H, Hkv = 8, 4, 1
    lens = torch.tensor([256 + 183 * i for i in range(B)], device=dev)
    for S, tag_s in ((512, "ring"), (2048, "global")):
        valid = torch.arange(S, device=dev)[None] < lens.clamp(max=S)[:, None]
        keys = int(valid.sum())
        for dq, dv in ((256, 256), (128, 256)):
            q = rand(B, H, dq, dtype=bf)
            k, v = rand(B, S, Hkv, dq, dtype=bf), rand(B, S, Hkv, dv, dtype=bf)
            scale = 256 ** -0.5            # the dense logit scale, qk_full
            tag = f"gemma_{tag_s}_{dq}_{dv}"
            err = check_decode(q, k, v, valid, tag, 2e-2)
            kt, vt = (a.transpose(1, 2).repeat_interleave(H, dim=1)
                      for a in (k, v))
            qt, m4 = q[:, :, None], valid[:, None, None, :]
            calls = {"ms": lambda: decode_ops.decode_attention(
                         q, k, v, valid, scale=scale),
                     "plain_ms": lambda: decode_ref.decode_attention(
                         q, k, v, valid, scale),
                     "library_ms": lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, attn_mask=m4, scale=scale)}
            r = {"shape": [B, S, H, Hkv, dq, dv], "valid_keys": keys,
                 "max_abs_err": err,
                 **{key: device_ms(fn) for key, fn in calls.items()}}
            r["bound_ms"], r["bound_by"] = bound_ms(
                2.0 * H * keys * (dq + dv),
                keys * Hkv * (dq + dv) * 2 + 2 * B * H * (dq + dv) + B * S,
                PEAK_BF16_FLOPS)
            print(f"  flash_decode {tag} (lengths {int(lens[0])}.."
                  f"{int(lens[-1])}, {keys} valid keys of {B * S}), device "
                  f"time: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
                  f"ms, SDPA {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            by_name["flash_decode"][tag] = r
            del q, k, v, kt, vt

    # gram: a stacked MLP tap of the prune (4 reps x 4 x 1024 tokens x
    # d_ff 6912); gram_cross: the class-3 speculative per-sample grams of
    # one stacked unit's queries (4 reps x 4 samples x 1 group, 4096
    # grouped query rows of 256)
    x = rand(4, 4096, 6912)
    err = check_gram(x, label="gemma MLP tap")
    r = {"shape": list(x.shape), "max_abs_err": err,
         "ms": time_ms(lambda: gram_ops.gram(x), reps=3, warmup=1),
         "plain_ms": time_ms(lambda: gram_ref.gram(x), reps=3, warmup=1),
         "library_ms": time_ms(lambda: torch.matmul(x.mT, x), reps=3,
                               warmup=1)}
    L, N, Fd = x.shape
    r["bound_ms"], r["bound_by"] = bound_ms(
        1.0 * L * N * Fd * (Fd + 1), 4.0 * (L * N * Fd + L * Fd * Fd + L * Fd))
    print(f"  gram at the gemma prune shape {tuple(x.shape)} fp32: kernel "
          f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, torch.matmul "
          f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']})")
    by_name["gram"]["gemma_prune"] = r
    del x
    xq = rand(16, 4096, 256)
    err = check_gram(xq, xq, label="gemma class-3 spec q")
    r = {"shape": list(xq.shape), "max_abs_err": err,
         "ms": device_ms(lambda: gram_ops.gram_cross(xq, xq), reps=10),
         "plain_ms": device_ms(lambda: gram_ref.gram_cross(xq, xq), reps=10),
         "library_ms": device_ms(lambda: torch.bmm(xq.mT, xq), reps=10)}
    I, N, Fd = xq.shape
    r["bound_ms"], r["bound_by"] = bound_ms(
        2.0 * I * N * Fd * Fd + I * N * Fd,
        4.0 * (2 * I * N * Fd + I * Fd * Fd + I * Fd))
    print(f"  gram_cross at the gemma class-3 speculative shape "
          f"{tuple(xq.shape)} fp32, device time: kernel {r['ms']:.4f} ms, "
          f"plain {r['plain_ms']:.4f} ms, torch.bmm {r['library_ms']:.4f} "
          f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    by_name["gram_cross"]["gemma_spec"] = r
    del xq


def one_traversal_hit(tag, model, params, calib, held, dense, pc, logits):
    """``corp_prune(one_traversal=True, spec_margin=1.0)``: a sure hit (1
    traversal, no miss, ``gram_cross`` launched) within 1e-4 of the
    two-pass prune's held-out ``logits``. Returns its launches."""
    _, _, r1, l1, lg1, _ = lm_prune_run(
        tag, model, params, calib, held, dense, pc, one_traversal=True,
        spec_margin=1.0)
    spec = r1["speculative"]
    err = rel_err(lg1, logits)
    print(f"[{tag}] margin 1.0: traversals {r1['traversals']}, "
          f"{len(spec['hits'])} hits, misses {spec['misses']}; held-out "
          f"|one - two-pass| / |two-pass| fp32 logits {err:.3e} (tol 1e-4)")
    if r1["traversals"] != 1 or spec["misses"] or l1["gram_cross"] <= 0:
        fail(f"{tag}: a full candidate set missed, or gram_cross never ran")
    if not err <= 1e-4:
        fail(f"{tag}: more than 1e-4 from the two-pass prune")
    return l1


def prune_gemma_phase(dev):
    """CORP of gemma3-1b at full width (seeded bf16 weights, the port-only
    Zipf stream, sequences of 1024 > the 512 window): two-pass at
    0.5/0.5, compensated and not, attention only (MLP 0; the class-3
    numbers, reported), MLP only (attention 0), compensated and not
    (gated: compensated closer to the dense model), and one traversal at
    margin 1.0 (a sure hit, <= 1e-4
    from two-pass). Returns ({path: launches}, the compensated pruned
    params and config)."""
    import torch
    from repro_torch.core import PruneConfig
    model, params = lm_model("gemma3-1b", dev)
    cfg = model.cfg
    calib, held = lm_calib(cfg, dev, seed=13, spec=GEMMA)
    dense = logits32(cfg, params, held)
    sp = GEMMA["sparsity"]
    print(f"[prune gemma] corp_prune of gemma3-1b ({cfg.layout()}), "
          f"{GEMMA['seqs']} sequences of {GEMMA['seq']} tokens in batches "
          f"of {GEMMA['batch']} (port-only Zipf stream), sparsity {sp}/{sp}")
    torch.cuda.reset_peak_memory_stats()
    new, ncfg, rep, launches, logits, comp = lm_prune_run(
        "prune gemma", model, params, calib, held, dense,
        PruneConfig(sp, sp))
    if (ncfg.eff_d_ff, ncfg.eff_qk) != (cfg.d_ff // 2, cfg.qk_full // 2):
        fail(f"prune gemma: d_ff {ncfg.eff_d_ff}, qk {ncfg.eff_qk}")
    for name in ("gram", "flash_attention"):
        if launches[name] <= 0:
            fail(f"prune gemma never launched {name}")
    qs = (tuple(new["seg0"]["p0"]["mixer"]["q_scale"].shape),
          tuple(new["seg1"]["l0"]["mixer"]["k_scale"].shape))
    want = ((cfg.layout()[0][1], cfg.n_heads, ncfg.eff_qk),
            (cfg.n_kv_heads, ncfg.eff_qk))
    if qs != want:
        fail(f"prune gemma: qk-norm scales of shapes {qs}, not the per-head "
             f"{want} of a stacked and an unrolled layer")
    out = {"prune_gemma": launches}
    *_, nocomp = lm_prune_run(
        "prune gemma no-compensate", model, params, calib, held, dense,
        PruneConfig(sp, sp, compensate=False))
    attn = [u for u in rep["units"] if u.endswith("/attn")]
    rho = [float(rep["units"][u]["rho2"].mean()) for u in attn]
    print(f"[prune gemma] MLP and class-3 attention at {sp}/{sp}: held-out "
          f"fp32 logits |pruned - dense| / |dense| compensated {comp:.4f}, "
          f"no-compensate {nocomp:.4f}; mean rho2 (the logit distortion "
          f"the class-3 ridge removes) of the {len(attn)} attention units "
          f"{min(rho):.4f}..{max(rho):.4f}")
    *_, att_comp = lm_prune_run("prune gemma attention only", model,
                                params, calib, held, dense,
                                PruneConfig(0.0, sp))
    *_, att_plain = lm_prune_run(
        "prune gemma attention only no-compensate", model, params, calib,
        held, dense, PruneConfig(0.0, sp, compensate=False))
    print(f"[prune gemma] class 3 alone (MLP 0, attention {sp}): held-out "
          f"compensated {att_comp:.4f}, no-compensate {att_plain:.4f} "
          f"(reported, not gated)")
    *_, mlp_comp = lm_prune_run("prune gemma MLP only", model, params,
                                calib, held, dense, PruneConfig(sp, 0.0))
    *_, mlp_plain = lm_prune_run(
        "prune gemma MLP only no-compensate", model, params, calib, held,
        dense, PruneConfig(sp, 0.0, compensate=False))
    print(f"[prune gemma] MLP only (attention 0): held-out compensated "
          f"{mlp_comp:.4f}, no-compensate {mlp_plain:.4f}")
    if not mlp_comp < mlp_plain:
        fail("prune gemma: the compensated MLP prune is not closer to the "
             "dense model than the uncompensated one")
    out["prune_gemma_1trav"] = one_traversal_hit(
        "prune gemma one traversal", model, params, calib, held, dense,
        PruneConfig(sp, sp), logits)
    del params, dense, logits
    return out, new, ncfg


def slot_bytes_by_kind(cfg, max_len):
    """Bytes of one slot's decode cache: (all layers, the ring layers'
    share, an all-global stack of the same depth)."""
    from repro_torch.interop import flatten
    from repro_torch.models import build_model
    from repro_torch.serve import cache_bytes
    tree = build_model(cfg).init_cache(1, max_len, "meta")
    kinds = {}
    for si, seg in enumerate(cfg.layout()):
        for j, li in enumerate(seg[-1]):
            key = f"seg{si}/{'l' if seg[0] == 'unroll' else 'p'}{j}/"
            kinds[key] = cfg.layer_kinds[li]
    ring = sum(t.numel() * t.element_size()
               for path, t in flatten(tree).items()
               if kinds.get(path.rpartition("/")[0] + "/") == "swa")
    every = cache_bytes(build_model(cfg.replace(pattern=("attn",)))
                        .init_cache(1, max_len, "meta"))
    return cache_bytes(tree), ring, every


def serve_gemma_phase(dev):
    """gemma3-1b at full width through ``launch.serve``: every request of
    the trace completes, both attention kernels launched (window and global
    prefills, ring and global decode); the slot bytes of the ring layers
    against an all-global stack; then the fp32 logit check past the window.
    Returns {path: launches}."""
    launches, res = serve_phase(GEMMA_SERVE, "serve gemma",
                                ("flash_attention", "flash_decode"))
    arg = dict(zip(GEMMA_SERVE[::2], GEMMA_SERVE[1::2]))
    want = [r.gen for r in cli_trace(arg, res["model"].cfg)]
    if [len(c.tokens) for c in res["completions"]] != want:
        fail("serve gemma: a request did not complete")
    cfg = res["model"].cfg
    max_len = int(arg["--max-len"])
    total, ring, every = slot_bytes_by_kind(cfg, max_len)
    print(f"[serve gemma] slot-cache bytes per slot at max_len {max_len}: "
          f"{total} ({ring} in the {cfg.layer_kinds.count('swa')} ring "
          f"layers of {min(max_len, cfg.sliding_window)} slots, "
          f"{100 * ring / total:.1f}%); an all-global stack of "
          f"{cfg.n_layers} layers: {every} ({every / total:.2f}x)")
    logit_phase(res["model"], res["params"], "gemma logits", [600, 600])
    return {"serve_gemma": launches}


def cli_trace(arg, cfg):
    """The synthetic trace that a serve CLI's flags (``arg``: flag ->
    value) give."""
    from repro_torch.serve import synthetic_trace
    return synthetic_trace(
        int(arg["--trace"]), cfg.vocab_size, seed=0,
        prompt_range=tuple(map(int, arg["--prompt-range"].split(","))),
        gen_range=tuple(map(int, arg["--gen-range"].split(","))))


def serve_pruned_gemma_phase(params, cfg):
    """The pruned gemma3-1b saved and served by ``launch.serve --sparsity
    0.5 --ckpt-in``: its per-head qk-norm scales restored, every request
    complete. Returns {path: launches}."""
    leaf = "seg0/p0/mixer/q_scale"
    want = params["seg0"]["p0"]["mixer"]["q_scale"].cpu()
    ck = save_pruned("serve pruned gemma", params, cfg, "gemma")
    launches = serve_pruned_ckpt(GEMMA_PRUNED_SERVE, "serve pruned gemma",
                                 ck, cfg, leaf, want)
    max_len = int(dict(zip(GEMMA_PRUNED_SERVE[::2],
                           GEMMA_PRUNED_SERVE[1::2]))["--max-len"])
    total, ring, _ = slot_bytes_by_kind(cfg, max_len)
    print(f"[serve pruned gemma] slot-cache bytes per slot at max_len "
          f"{max_len}: {total} ({ring} in the ring layers; K rows dq "
          f"{cfg.qk_full} -> {cfg.eff_qk})")
    return {"serve_pruned_gemma": launches}


def gemma_reference_phase():
    """Reduced gemma3-1b at 8 layers (a scanned segment of 6 and 2 unrolled
    layers, window 8), granite-8b and deepseek-7b (fp32, seeded weights) on
    the GPU against the CPU's plain path: logits of a sequence longer than
    the window within 1e-3, and equal engine streams over a ragged
    trace."""
    import torch
    from repro_torch.configs import resolve_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine, synthetic_trace
    for arch, n_layers in (("gemma3-1b", 8), ("granite-8b", None),
                           ("deepseek-7b", None)):
        cfg = resolve_config(arch + "-reduced")
        if n_layers:
            cfg = cfg.replace(n_layers=n_layers)
        model = build_model(cfg)
        toks = (torch.arange(2 * 40, dtype=torch.int32).reshape(2, 40) * 7) \
            % cfg.vocab_size
        logits, streams = {}, {}
        for device in ("cuda", "cpu"):
            params = model.init(torch.Generator().manual_seed(0), device)
            logits[device] = model.apply(
                params, {"tokens": toks.to(device)})[0].cpu()
            eng = ServeEngine(model, params, n_slots=3, max_len=96)
            streams[device] = [c.tokens.tolist() for c in eng.run(
                synthetic_trace(12, cfg.vocab_size, seed=0,
                                prompt_range=(8, 40), gen_range=(4, 30)))]
        err = rel_err(logits["cuda"], logits["cpu"])
        same = streams["cuda"] == streams["cpu"]
        print(f"[reference gemma] {cfg.name} ({cfg.n_layers} layers, "
              f"{cfg.layout()}): logits GPU vs CPU relative error "
              f"{err:.3e} (tol 1e-3); engine streams "
              f"{sum(map(len, streams['cuda']))} tokens, "
              f"{'identical' if same else 'DIFFERENT'}")
        if not (err <= 1e-3 and same):
            fail(f"{cfg.name}: the GPU disagrees with the CPU's plain path")


# ---------------------------------------------------------------------------
# internvl2-26b (the VLM stub frontend on a dense GQA backbone) and
# qwen3-moe-235b-a22b (routed experts with capacity, class-3 attention)
# ---------------------------------------------------------------------------

# the serve trace of the large models at full width: 16 requests, 8 slots,
# weights drawn on the card (20 G normals on the host take minutes)
BIG_TRACE = ["--trace", "16", "--slots", "8", "--max-len", "2048",
             "--prompt-range", "64,512", "--gen-range", "32,128",
             "--init-on-device"]
# internvl2-26b serves at full width and 16 of its 48 layers (13.6 GB of
# bf16 weights; the 48-layer run took its decode steps to 72.49 ms, in a
# script that needed the time for jamba)
INTERNVL_SERVE = ["--arch", "internvl2-26b", "--n-layers", "16"] + BIG_TRACE
# its prune at full width and 8 layers: at 48 the MLP second moments alone
# are 48 x 16384^2 x 4 B = 51.5 GB; 8 patches before each sequence, 256
# sequences (16 calibration tokens a kept channel)
INTERNVL = dict(sparsity=0.5, seqs=256, seq=512, batch=4, held=2,
                patches=8, layers=8)
INTERNVL_PRUNED_SERVE = ["--arch", "internvl2-26b", "--n-layers", "8",
                         "--sparsity", "0.5", "--trace", "8"] + BIG_TRACE[2:]
# qwen3-moe-235b-a22b at full width and 8 of its 94 layers (42.3 GB); a
# batch of 4 x 512 tokens is one routing group of 2048 tokens, 160 slots an
# expert; 128 sequences (~4k rows an expert, cut from 512 for the time of
# [calib sharded]: its gate is on calibration tokens)
MOE_SERVE = ["--arch", "qwen3-moe-235b-a22b", "--n-layers", "8"] + BIG_TRACE
MOE = dict(sparsity=0.5, seqs=128, seq=512, batch=4, held=2, layers=8)
MOE_PRUNED_SERVE = MOE_SERVE[:4] + ["--sparsity", "0.5"] + MOE_SERVE[4:]


def moe_kernel_phase(dev, rows):
    """``gram``, ``flash_attention`` and ``flash_decode`` at the shapes the
    internvl2-26b and qwen3-moe paths give them: the internvl MLP tap (8
    layers, 4 x 520 tokens, d_ff 16384), the MoE per-expert moments (8
    layers x 128 experts = 1024 items of 160 capacity slots, d_expert
    1536, masked slots zero), causal GQA prefill at groups 6 (48/8) and 16
    (64/4), and decode at both groups, dense (dq 128) and pruned (dq 64);
    each against its plain version, timed beside its bound and the one-call
    PyTorch equivalent."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.flash_decode import ops as decode_ops
    from repro_torch.kernels.flash_decode import ref as decode_ref
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram import ref as gram_ref
    by_name = {row["name"]: row for row in rows}
    g = torch.Generator(device=dev).manual_seed(19)
    bf = torch.bfloat16

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    print("[kernels internvl moe] the kernels against their plain versions "
          "at the internvl2-26b and qwen3-moe shapes")
    moe_x = rand(1024, 160, 1536)
    moe_x[:, 128:] = 0.0           # the queues' empty capacity slots
    for x, tag, label in ((rand(8, 4 * 520, 16384), "internvl_prune",
                           "internvl MLP tap"),
                          (moe_x, "moe_experts", "MoE expert moments")):
        err = check_gram(x, label=label)
        s2 = gram_ops.gram(x)["s2"]
        if not torch.equal(s2, s2.mT):
            fail(f"gram {label}: s2 is not exactly symmetric")
        del s2
        r = {"shape": list(x.shape), "max_abs_err": err,
             "ms": time_ms(lambda: gram_ops.gram(x), reps=3, warmup=1),
             "plain_ms": time_ms(lambda: gram_ref.gram(x), reps=3,
                                 warmup=1),
             "library_ms": time_ms(lambda: torch.matmul(x.mT, x), reps=3,
                                   warmup=1)}
        L, N, Fd = x.shape
        r["bound_ms"], r["bound_by"] = bound_ms(
            1.0 * L * N * Fd * (Fd + 1),
            4.0 * (L * N * Fd + L * Fd * Fd + L * Fd))
        print(f"  gram at the {label} shape {tuple(x.shape)} fp32: kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"torch.matmul {r['library_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
        by_name["gram"][tag] = r
        del x
    del moe_x
    torch.cuda.empty_cache()

    for (B, T, H, Hkv), tag in (((4, 520, 48, 8), "internvl_prefill"),
                                ((4, 512, 64, 4), "moe_prefill")):
        d = 128
        q, k, v = rand(B, T, H, d, dtype=bf), rand(B, T, Hkv, d, dtype=bf), \
            rand(B, T, Hkv, d, dtype=bf)
        scale = d ** -0.5
        err = check_attention(q, k, v, True, None, scale,
                              f"{tag} group {H // Hkv}", tol=2e-2)
        qt = q.transpose(1, 2)
        kt, vt = (a.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                  for a in (k, v))
        calls = {"ms": lambda: flash_ops.attention(q, k, v, causal=True,
                                                   scale=scale),
                 "plain_ms": lambda: flash_ref.attention(
                     q, k, v, causal=True, scale=scale),
                 "library_ms": lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, is_causal=True, scale=scale)}
        r = {"shape": [B, T, H, Hkv, d], "max_abs_err": err,
             **{key: device_ms(fn, reps=10) for key, fn in calls.items()}}
        r["bound_ms"], r["bound_by"] = bound_ms(
            2.0 * B * H * visible_keys(T, None) * 2 * d,
            2 * B * T * (2 * H + 2 * Hkv) * d, PEAK_BF16_FLOPS)
        print(f"  flash_attention {tag} B={B} T={T} H={H}/{Hkv} d={d} bf16 "
              f"causal, device time: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        by_name["flash_attention"][tag] = r
        del q, k, v, qt, kt, vt

    B, S = 8, 2048
    lens = torch.tensor([64 + 70 * i for i in range(B)], device=dev)
    valid = torch.arange(S, device=dev)[None] < lens[:, None]
    keys = int(valid.sum())
    for H, Hkv, name in ((48, 8, "internvl"), (64, 4, "moe")):
        for dq in (128, 64):
            dv = 128
            q = rand(B, H, dq, dtype=bf)
            k, v = rand(B, S, Hkv, dq, dtype=bf), rand(B, S, Hkv, dv, dtype=bf)
            scale = 128 ** -0.5
            tag = f"{name}_decode_{dq}_{dv}"
            err = check_decode(q, k, v, valid, tag, 2e-2)
            kt, vt = (a.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                      for a in (k, v))
            qt, m4 = q[:, :, None], valid[:, None, None, :]
            calls = {"ms": lambda: decode_ops.decode_attention(
                         q, k, v, valid, scale=scale),
                     "plain_ms": lambda: decode_ref.decode_attention(
                         q, k, v, valid, scale),
                     "library_ms": lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, attn_mask=m4, scale=scale)}
            r = {"shape": [B, S, H, Hkv, dq, dv], "valid_keys": keys,
                 "max_abs_err": err,
                 **{key: device_ms(fn) for key, fn in calls.items()}}
            r["bound_ms"], r["bound_by"] = bound_ms(
                2.0 * H * keys * (dq + dv),
                keys * Hkv * (dq + dv) * 2 + 2 * B * H * (dq + dv) + B * S,
                PEAK_BF16_FLOPS)
            print(f"  flash_decode {tag} group {H // Hkv} ({keys} valid "
                  f"keys of {B * S}), device time: kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, SDPA "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
            by_name["flash_decode"][tag] = r
            del q, k, v, kt, vt


def big_lm(arch, dev, n_layers=None):
    """A full-width LM (cut to ``n_layers``) with seeded weights drawn on
    the card through the port's init functions."""
    from repro_torch.interop import flatten
    import torch
    from repro_torch.configs import resolve_config
    from repro_torch.models import build_model
    cfg = resolve_config(arch)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = build_model(cfg)
    t0 = time.time()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in flatten(params).values())
    print(f"[{arch}] {cfg.n_layers} layers, {n / 1e9:.3f} G parameters "
          f"drawn on the card in {time.time() - t0:.3f} s")
    return model, params


def patch_calib(cfg, dev, spec, seed):
    """``lm_calib``'s Zipf tokens with ``spec['patches']`` patch embeddings
    (standard normals, drawn on the card) before each sequence: the
    port-only stand-in for the reference's patch-stub stream, whose Markov
    table is 92,672^2 x 4 B = 34 GB at internvl2-26b's vocabulary."""
    import torch
    calib, held = lm_calib(cfg, dev, seed=seed, spec=spec)
    g = torch.Generator(device=dev).manual_seed(seed + 2)

    def patches(b):
        return torch.randn((b, spec["patches"], cfg.d_model), generator=g,
                           device=dev)
    batches = [dict(b, patch_embeds=patches(len(b["tokens"])))
               for b in calib()]
    return (lambda: iter(batches)), dict(
        held, patch_embeds=patches(len(held["tokens"])))


def logits_bf16(cfg, params, batch):
    """Held-out logits of a model too large to copy to fp32 (qwen3-moe at
    42 GB): its own bf16 forward, the logits read in fp32."""
    from repro_torch.models import build_model
    return build_model(cfg).apply(params, batch)[0].float()


def serve_internvl_phase(dev):
    """internvl2-26b at full width and 16 layers through ``launch.serve``:
    every request served, both attention kernels launched, its slot bytes;
    then a prefill of 256 patch embeddings and 16 tokens, and 4 decode
    steps, on the GPU against the CPU's plain path on a reduced copy (<=
    1e-3).
    Returns {path: launches}."""
    import torch
    from repro_torch.configs import resolve_config
    from repro_torch.models import build_model
    from repro_torch.serve import cache_bytes
    launches, res = serve_phase(INTERNVL_SERVE, "serve internvl",
                                ("flash_attention", "flash_decode"))
    cfg = res["model"].cfg
    arg = dict(zip(INTERNVL_SERVE[::2], INTERNVL_SERVE[1::2]))
    if [len(c.tokens) for c in res["completions"]] \
            != [r.gen for r in cli_trace(arg, cfg)]:
        fail("serve internvl: a request did not complete")
    max_len = int(arg["--max-len"])
    slot = cache_bytes(build_model(cfg).init_cache(1, max_len, "meta"))
    print(f"[serve internvl] {cfg.n_layers} layers; slot-cache bytes per "
          f"slot at max_len {max_len}: {slot} ({slot / max_len:.0f} a "
          f"token)")
    del res
    torch.cuda.empty_cache()
    cfg = resolve_config("internvl2-26b-reduced")
    model = build_model(cfg)
    toks = (torch.arange(2 * 20, dtype=torch.int32).reshape(2, 20) * 11) \
        % cfg.vocab_size
    pe = torch.randn((2, 256, cfg.d_model),
                     generator=torch.Generator().manual_seed(3))
    out = {}
    for device in ("cuda", "cpu"):
        params = model.init(torch.Generator().manual_seed(0), device)
        logits, cache = model.prefill(
            params, {"tokens": toks[:, :16].to(device),
                     "patch_embeds": pe.to(device)}, 300)
        rows = [logits[:, 0]]
        for i in range(16, 20):
            logits, cache = model.decode_step(
                params, toks[:, i:i + 1].to(device), cache)
            rows.append(logits[:, 0])
        out[device] = torch.stack(rows).cpu()
        if int(cache["pos"][0]) != 256 + 20:
            fail("serve internvl: the patch prefill's cache pos is not P + T")
    err = rel_err(out["cuda"], out["cpu"])
    print(f"[serve internvl] {cfg.name}: prefill of 256 patch embeddings + "
          f"16 tokens and 4 decode steps, logits GPU vs CPU relative error "
          f"{err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        fail("serve internvl: the patch prefill on the GPU disagrees with "
             "the CPU's plain path")
    return {"serve_internvl": launches}


def prune_internvl_phase(dev):
    """CORP of internvl2-26b at full width and 8 layers (seeded bf16
    weights, Zipf tokens after 8 patch embeddings): 0.5/0.5 two-pass,
    compensated and not (gated: compensated closer to the dense model on
    held-out logits), and one traversal at margin 1.0 (a hit, <= 1e-4 from
    two-pass). Returns ({path: launches}, the compensated pruned params
    and config)."""
    import torch
    from repro_torch.core import PruneConfig
    model, params = big_lm("internvl2-26b", dev, INTERNVL["layers"])
    cfg = model.cfg
    calib, held = patch_calib(cfg, dev, INTERNVL, seed=17)
    dense = logits32(cfg, params, held)
    sp = INTERNVL["sparsity"]
    print(f"[prune internvl] corp_prune of internvl2-26b at "
          f"{cfg.n_layers} layers ({cfg.layout()}), {INTERNVL['seqs']} "
          f"sequences of {INTERNVL['patches']} patches + {INTERNVL['seq']} "
          f"tokens in batches of {INTERNVL['batch']} (port-only Zipf "
          f"stream), sparsity {sp}/{sp}")
    torch.cuda.reset_peak_memory_stats()
    new, ncfg, rep, launches, logits, comp = lm_prune_run(
        "prune internvl", model, params, calib, held, dense,
        PruneConfig(sp, sp))
    if (ncfg.eff_d_ff, ncfg.eff_qk) != (cfg.d_ff // 2, cfg.qk_full // 2):
        fail(f"prune internvl: d_ff {ncfg.eff_d_ff}, qk {ncfg.eff_qk}")
    for name in ("gram", "flash_attention"):
        if launches[name] <= 0:
            fail(f"prune internvl never launched {name}")
    out = {"prune_internvl": launches}
    *_, plain = lm_prune_run(
        "prune internvl no-compensate", model, params, calib, held, dense,
        PruneConfig(sp, sp, compensate=False))
    print(f"[prune internvl] held-out fp32 logits |pruned - dense| / |dense| "
          f"compensated {comp:.4f}, no-compensate {plain:.4f}")
    if not comp < plain:
        fail("prune internvl: the compensated prune is not closer to the "
             "dense model than the uncompensated one")
    out["prune_internvl_1trav"] = one_traversal_hit(
        "prune internvl one traversal", model, params, calib, held, dense,
        PruneConfig(sp, sp), logits)
    del params, dense, logits
    return out, new, ncfg


def serve_moe_phase(dev):
    """qwen3-moe-235b-a22b at full width and 8 layers through
    ``launch.serve``: every request served. Returns {path: launches}."""
    from repro_torch.interop import flatten
    launches, res = serve_phase(MOE_SERVE, "serve moe",
                                ("flash_attention", "flash_decode"))
    cfg = res["model"].cfg
    arg = dict(zip(MOE_SERVE[::2], MOE_SERVE[1::2]))
    if [len(c.tokens) for c in res["completions"]] \
            != [r.gen for r in cli_trace(arg, cfg)]:
        fail("serve moe: a request did not complete")
    experts = sum(t.numel() * t.element_size() for k, t in
                  flatten(res["params"]).items()
                  if k.rsplit("/", 1)[-1] in ("wg", "wu", "wd"))
    print(f"[serve moe] {cfg.n_layers} layers of {cfg.moe.num_experts} "
          f"experts, top {cfg.moe.top_k}: every decode step reads "
          f"{experts / 1e9:.2f} GB of expert weights (>= "
          f"{1e3 * experts / PEAK_BYTES:.2f} ms at {PEAK_BYTES / 1e12:.2f} "
          f"TB/s)")
    return {"serve_moe": launches}


def prune_moe_phase(dev, launches):
    """CORP of qwen3-moe-235b-a22b at full width and 8 layers (seeded bf16
    weights, the port-only Zipf stream, batches of 4 x 512 tokens: one
    routing group, 160 slots an expert): 0.5/0.5 compensated (each
    expert's hidden channels; class-3 attention), whose per-expert moments
    take one ``gram`` launch of 1024 items a batch (gated); MLP only,
    compensated and not: the MoE blocks' output error
    (``block_errors``) on calibration tokens, gated compensated <
    plain (the fold applies what the ridge solved), and on held-out
    tokens, reported with the logits. Seeded experts are random features
    of x with d_expert 1536 < d 4096: their channels are near
    uncorrelated, so the held-out gain of the ridge is below its
    estimation noise at 16k rows an expert (PERF.md; ~4k here). Held-out
    logits are the bf16 model's (42 GB do not fit twice in fp32). The
    0.5/0.5 model
    is served in process (``[serve pruned moe]``); its checkpoint round
    trip runs on the reduced config (``[reference moe]``). Its launches are
    added to ``launches``."""
    import torch
    from repro_torch.core import PruneConfig
    model, params = big_lm("qwen3-moe-235b-a22b", dev, MOE["layers"])
    cfg = model.cfg
    calib, held = lm_calib(cfg, dev, seed=23, spec=MOE)
    dense = logits_bf16(cfg, params, held)
    sp = MOE["sparsity"]
    batches = MOE["seqs"] // MOE["batch"]
    print(f"[prune moe] corp_prune of qwen3-moe-235b-a22b at {cfg.n_layers} "
          f"layers ({cfg.layout()}), {MOE['seqs']} sequences of "
          f"{MOE['seq']} tokens in {batches} batches of {MOE['batch']} "
          f"(port-only Zipf stream), sparsity {sp}/{sp}")
    torch.cuda.reset_peak_memory_stats()
    new, ncfg, rep, ran, _, comp = lm_prune_run(
        "prune moe", model, params, calib, held, dense, PruneConfig(sp, sp),
        evaluate=logits_bf16)
    mlp = new["seg0"]["p0"]["mlp"]
    L, E, D = cfg.n_layers, cfg.moe.num_experts, cfg.d_model
    if (ncfg.eff_d_expert, ncfg.eff_qk) != (cfg.moe.d_expert // 2,
                                            cfg.qk_full // 2) \
            or tuple(mlp["bd_moe"].shape) != (L, E, D) \
            or tuple(mlp["wd"].shape) != (L, E, cfg.moe.d_expert // 2, D):
        fail(f"prune moe: d_expert {ncfg.eff_d_expert}, qk {ncfg.eff_qk}, "
             f"bd_moe {tuple(mlp['bd_moe'].shape)}")
    if ran["gram"] != batches or ran["flash_attention"] <= 0:
        fail(f"prune moe: {ran['gram']} gram launches for {batches} "
             f"batches (one a batch: every (layer, expert) queue in one), "
             f"or flash_attention never ran")
    launches["prune_moe"] = ran
    t0 = time.time()
    launches["serve_pruned_moe"] = serve_in_process(
        MOE_PRUNED_SERVE, "serve pruned moe", ncfg, new,
        ("seg0/p0/mlp/bd_moe",), ("flash_attention", "flash_decode"))
    print(f"[serve pruned moe] phase wall {time.time() - t0:.3f} s")
    del new, mlp
    torch.cuda.empty_cache()
    # the first 4 calibration batches, whose 4 x 512 tokens each route as
    # one group, as they did in pass 1
    seen = {"tokens": torch.cat([b["tokens"] for b in
                                 itertools.islice(calib(), 4)])}
    errs, block, fit = {}, {}, {}
    for comp_mlp in (True, False):
        tag = f"prune moe MLP only{'' if comp_mlp else ' no-compensate'}"
        run = lm_prune_run(tag, model, params, calib, held, dense,
                           PruneConfig(sp, 0.0, compensate=comp_mlp),
                           evaluate=logits_bf16)
        errs[comp_mlp] = run[-1]
        block[comp_mlp] = block_errors(cfg, params, run[1], run[0],
                                       held)["moe"]
        fit[comp_mlp] = block_errors(cfg, params, run[1], run[0],
                                     seen)["moe"]
        del run             # a pruned model (20 GB) must not outlive it
        torch.cuda.empty_cache()
    print(f"[prune moe] 0.5/0.5 held-out logits |pruned - dense| / |dense| "
          f"{comp:.4f}; MLP only (attention 0): logits compensated "
          f"{errs[True]:.4f}, no-compensate {errs[False]:.4f}; the MoE "
          f"blocks' outputs |pruned - dense| / |dense| on the dense model's "
          f"held-out inputs: compensated {block[True]:.4f}, no-compensate "
          f"{block[False]:.4f} (reported); on 4 calibration batches: "
          f"compensated {fit[True]:.4f}, no-compensate {fit[False]:.4f}")
    if not fit[True] < fit[False]:
        fail("prune moe: on its calibration tokens the compensated MoE "
             "blocks are not closer to the dense ones than the "
             "uncompensated blocks: the per-expert fold is not what the "
             "ridge solved")
    del params, dense
    torch.cuda.empty_cache()


def moe_reference_phase():
    """The reduced qwen3-moe and internvl2-26b (fp32) on the GPU against
    the CPU's plain path: the dense engines' streams; ``launch.prune
    --calib-seq 16`` (qwen3-moe also with ``--expert-sparsity 0.5``, the
    whole-expert removal whose ((E+1) D)^2 moments are 1.1 TB a layer at
    full width) and its checkpoint served through ``--ckpt-in``
    (``reference_prune_cases``: the MoE checkpoint round trip, with
    ``bd_moe``, ``moe_resid`` and ``moe_out_b`` restored)."""
    for arch in ("qwen3-moe-235b-a22b-reduced", "internvl2-26b-reduced"):
        serve_reference_phase(["--arch", arch] + SERVE_REDUCED[2:],
                              "reference moe")
    experts = ["--expert-sparsity", "0.5"]
    reference_prune_cases("reference moe", [
        ("qwen3-moe-235b-a22b-reduced", [], []),
        ("qwen3-moe-235b-a22b-reduced", experts, experts),
        ("internvl2-26b-reduced", [], [])])


def internvl_moe_phases(dev, rows, launches):
    """The internvl2-26b and qwen3-moe phases in order, each timed; their
    launches are added to ``launches``."""
    import torch
    for tag, fn in (("kernels internvl moe",
                     lambda: moe_kernel_phase(dev, rows)),
                    ("serve internvl",
                     lambda: launches.update(serve_internvl_phase(dev)))):
        t0 = time.time()
        fn()
        print(f"[{tag}] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    lm_launches, new, ncfg = prune_internvl_phase(dev)
    launches.update(lm_launches)
    print(f"[prune internvl] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    launches["serve_pruned_internvl"] = serve_in_process(
        INTERNVL_PRUNED_SERVE, "serve pruned internvl", ncfg, new,
        ("seg0/p0/mlp/bd",), ("flash_attention", "flash_decode"))
    del new
    print(f"[serve pruned internvl] phase wall {time.time() - t0:.3f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    launches.update(serve_moe_phase(dev))
    print(f"[serve moe] phase wall {time.time() - t0:.3f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    prune_moe_phase(dev, launches)
    print(f"[prune moe] phase wall {time.time() - t0:.3f} s (with [serve "
          f"pruned moe])")
    torch.cuda.empty_cache()
    t0 = time.time()
    moe_reference_phase()
    print(f"[reference moe] phase wall {time.time() - t0:.3f} s")


# ---------------------------------------------------------------------------
# deepseek-v3-671b (MLA, 3 dense layers of 18432, 256 routed experts of
# 2048 with top 8 and one shared expert)
# ---------------------------------------------------------------------------

# full width at 4 of its 61 layers: the 3 first_k_dense layers and one MoE
# layer (30.2 GB of bf16 weights, drawn on the card); at 5 layers (53 GB)
# no pruned copy fits beside it
DEEPSEEK_SERVE = ["--arch", "deepseek-v3-671b", "--n-layers", "4"] \
    + BIG_TRACE
# 256 calibration sequences of 512 tokens in batches of 4 (one routing
# group of 2048 tokens, 80 slots an expert): 14.2 tokens a kept dense
# channel; the Qwen2 ridge overfits at 3.66 and not at 14.6
# (tests/lm_overfit_witness.py)
DEEPSEEK = dict(sparsity=0.5, seqs=256, seq=512, batch=4, held=2, layers=4)
DEEPSEEK_PRUNED_SERVE = DEEPSEEK_SERVE[:4] + ["--sparsity", "0.5"] \
    + DEEPSEEK_SERVE[4:]


def deepseek_kernel_phase(dev, rows):
    """``flash_attention`` and ``gram`` at the shapes deepseek-v3's paths
    give them: the MLA prefill and calibration forward (B 4, T 512, 128
    heads, q/k 192 = nope 128 + rope 64 against v 128, causal, scale
    1/sqrt(192)) dense and pruned (q/k 128 at the same scale), in bf16 and
    fp32; ``gram`` at the three dense layers' MLP tap (3, 2048, 18432) and
    over the MoE layer's 256 expert queues of 80 capacity slots at 2048;
    each against its plain version, timed beside its bound and the
    one-call PyTorch equivalent (SDPA, ``torch.matmul``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram import ref as gram_ref
    by_name = {row["name"]: row for row in rows}
    g = torch.Generator(device=dev).manual_seed(20)
    bf = torch.bfloat16

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    print("[kernels deepseek] the kernels against their plain versions at "
          "the deepseek-v3-671b shapes")
    B, T, H, dv = 4, 512, 128, 128
    scale = 192 ** -0.5
    for dq, tag in ((192, "deepseek_prefill"),
                    (128, "deepseek_prefill_pruned")):
        for dtype, tol in ((torch.float32, 1e-4), (bf, 2e-2)):
            q, k = rand(B, T, H, dq, dtype=dtype), rand(B, T, H, dq,
                                                        dtype=dtype)
            v = rand(B, T, H, dv, dtype=dtype)
            err = check_attention(q, k, v, True, None, scale,
                                  f"{tag} {str(dtype)[6:]}", tol=tol)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        library = "SDPA"
        try:
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           scale=scale)
        except RuntimeError:        # a backend that needs dq == dv
            vt = F.pad(vt, (0, dq - dv))
            library = f"SDPA, v padded to {dq}"
        calls = {"ms": lambda: flash_ops.attention(q, k, v, causal=True,
                                                   scale=scale),
                 "plain_ms": lambda: flash_ref.attention(
                     q, k, v, causal=True, scale=scale),
                 "library_ms": lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, is_causal=True, scale=scale)}
        r = {"shape": [B, T, H, H, dq, dv], "max_abs_err": err,
             "library": library,
             **{key: device_ms(fn, reps=10) for key, fn in calls.items()}}
        r["bound_ms"], r["bound_by"] = bound_ms(
            2.0 * B * H * visible_keys(T, None) * (dq + dv),
            2 * B * T * H * (2 * dq + 2 * dv), PEAK_BF16_FLOPS)
        print(f"  flash_attention {tag} B={B} T={T} H={H} dq={dq} dv={dv} "
              f"bf16 causal, device time: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, {library} {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        by_name["flash_attention"][tag] = r
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    experts = rand(256, 80, 2048)
    experts[:, 64:] = 0.0          # the queues' empty capacity slots
    for x, tag, label in ((rand(3, 4 * 512, 18432), "deepseek_dense",
                           "dense MLP tap"),
                          (experts, "deepseek_experts",
                           "expert queues")):
        err = check_gram(x, label=label)
        s2 = gram_ops.gram(x)["s2"]
        if not torch.equal(s2, s2.mT):
            fail(f"gram {label}: s2 is not exactly symmetric")
        del s2
        r = {"shape": list(x.shape), "max_abs_err": err,
             "ms": time_ms(lambda: gram_ops.gram(x), reps=3, warmup=1),
             "plain_ms": time_ms(lambda: gram_ref.gram(x), reps=3,
                                 warmup=1),
             "library_ms": time_ms(lambda: torch.matmul(x.mT, x), reps=3,
                                   warmup=1)}
        L, N, Fd = x.shape
        r["bound_ms"], r["bound_by"] = bound_ms(
            1.0 * L * N * Fd * (Fd + 1),
            4.0 * (L * N * Fd + L * Fd * Fd + L * Fd))
        print(f"  gram at the {label} shape {tuple(x.shape)} fp32: kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"torch.matmul {r['library_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
        by_name["gram"][tag] = r
        del x
        torch.cuda.empty_cache()
    del experts


def serve_in_process(args, tag, cfg, params, leaves, kernels):
    """A pruned model held in process, served by the serve CLI's trace path
    (``launch.serve.serve_trace``: the engine, warmed, then the trace of
    the CLI flags ``args``): every request completes, each kernel in
    ``kernels`` launched, and each compensation leaf in ``leaves`` (key
    paths) is in the served params and not zero. Returns {kernel:
    launches}."""
    import torch
    from repro_torch.interop import flatten
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    arg = dict(zip(args[::2], args[1::2]))
    flat = flatten(params)
    for leaf in leaves:
        if leaf not in flat or not bool(flat[leaf].any()):
            fail(f"{tag}: compensation leaf {leaf} missing or zero")
    print(f"[{tag}] the pruned model in process, through launch.serve's "
          f"trace path with the flags {' '.join(args)}")
    reset_launches()
    t0 = time.time()
    comps, table, st, *_ = serve.serve_trace(
        build_model(cfg), params, n=int(arg["--trace"]),
        slots=int(arg["--slots"]), max_len=int(arg["--max-len"]),
        prompt_range=tuple(map(int, arg["--prompt-range"].split(","))),
        gen_range=tuple(map(int, arg["--gen-range"].split(","))),
        mem_len=int(arg["--mem-len"]) if "--mem-len" in arg else None)
    torch.cuda.synchronize()
    launches = read_launches()
    prefills = sum(v for k, v in st.items() if k.startswith("prefill_b"))
    print(f"[{tag}] wall {time.time() - t0:.3f} s (warmup and the trace); "
          f"trace {table['wall_s']:.3f} s, {table['tokens']} tokens, "
          f"{table['tok_per_s']:.1f} tok/s, TTFT p50/p99 "
          f"{table['ttft_p50_ms']:.1f}/{table['ttft_p99_ms']:.1f} ms, "
          f"latency p50/p99 {table['lat_p50_ms']:.1f}/"
          f"{table['lat_p99_ms']:.1f} ms; "
          f"{1e3 * st['decode_s'] / max(1, st['decode_steps']):.2f} ms per "
          f"shared decode step, "
          f"{1e3 * st['prefill_s'] / max(1, prefills):.2f} ms per prefill; "
          f"launches {launches}; leaves {', '.join(leaves)} served")
    for name in kernels:
        if launches[name] <= 0:
            fail(f"the {tag} path never launched the {name} kernel")
    if [len(c.tokens) for c in comps] != [r.gen for r in
                                          cli_trace(arg, cfg)] \
            or not all(((0 <= c.tokens) & (c.tokens < cfg.vocab_size)).all()
                       for c in comps):
        fail(f"{tag}: a request did not complete")
    return launches


def serve_deepseek_phase(dev):
    """deepseek-v3-671b at full width and 4 layers through ``launch.serve``:
    every request served; the prefill runs the attention kernel (MLA decode
    is plain torch, as the reference's jnp); the latent slot cache's bytes
    against a per-head cache of the same heads. Returns {path:
    launches}."""
    from repro_torch.models import build_model
    from repro_torch.serve import cache_bytes
    launches, res = serve_phase(DEEPSEEK_SERVE, "serve deepseek",
                                ("flash_attention",))
    cfg = res["model"].cfg
    arg = dict(zip(DEEPSEEK_SERVE[::2], DEEPSEEK_SERVE[1::2]))
    if [len(c.tokens) for c in res["completions"]] \
            != [r.gen for r in cli_trace(arg, cfg)]:
        fail("serve deepseek: a request did not complete")
    if launches["flash_decode"]:
        fail("serve deepseek: MLA decode launched flash_decode")
    max_len = int(arg["--max-len"])
    slot = cache_bytes(build_model(cfg).init_cache(1, max_len, "meta"))
    m = cfg.mla
    per = (m.kv_lora_rank + m.qk_rope_dim) * 2
    heads = cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim + m.v_dim) * 2
    print(f"[serve deepseek] {cfg.n_layers} layers; latent slot cache "
          f"{slot} bytes per slot at max_len {max_len} ({per} a token and "
          f"layer); a cache of the {cfg.n_heads} heads' k and v would take "
          f"{heads} "
          f"a token and layer, {heads / per:.1f}x")
    return {"serve_deepseek": launches}


def block_errors(cfg, params, ncfg, new, batch):
    """Output errors of the pruned blocks alone, sum ||pruned - dense||^2 /
    sum ||dense||^2 over the layers of a kind, each block given the input
    that the dense model's forward over ``batch`` gives it: the mixers
    (``mla`` for MLA attention, else ``attn`` or ``mamba``), ``dense``
    (the dense MLPs), ``moe`` (the routed and shared experts). Unlike the
    logits, one layer's error does not reach the next layer's routing."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import blocks as blk
    from repro_torch.models import lm as lm_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.common import apply_norm
    x = params["embed"][batch["tokens"]]
    B, T = x.shape[:2]
    positions = lm_mod._positions(B, T, x.device)
    num, den = {}, {}

    def add(kind, yp, yd):
        num[kind] = num.get(kind, 0.0) + float(
            (yp.float() - yd.float()).square().sum())
        den[kind] = den.get(kind, 0.0) + float(yd.float().square().sum())

    def mixer(p, h, c, kind):
        if kind == "mamba":
            return ssm_mod.apply_mamba(p, h, c)[0]
        return attn_mod.apply_attn(p, h, c, kind, positions=positions)[0]
    for name, key, rep, kind, moe in lm_mod._each_layer(cfg):
        p = lm_mod._at(params, name, key, rep)
        q = lm_mod._at(new, name, key, rep)
        h = apply_norm(p["ln1"], x, cfg)
        yd = mixer(p["mixer"], h, cfg, kind)
        add("mla" if cfg.mla else kind, mixer(q["mixer"], h, ncfg, kind), yd)
        x = x + yd
        h = apply_norm(p["ln2"], x, cfg)
        yd = blk.ffn(p["mlp"], h, cfg, moe)
        add("moe" if moe else "dense", blk.ffn(q["mlp"], h, ncfg, moe), yd)
        x = x + yd
    return {k: math.sqrt(num[k] / den[k]) for k in num}


def mixers_only(cfg, params, ncfg, new):
    """The dense model with only its mixers pruned, attention (MLA) or
    Mamba (CORP takes every statistic from the dense model, so they are
    the mixer-only prune's): its config and params, the pruned mixers and
    every other leaf the dense one's."""
    out = dict(params)
    for seg in (k for k in new if k.startswith("seg")):
        out[seg] = {lk: dict(params[seg][lk], mixer=new[seg][lk]["mixer"])
                    for lk in new[seg]}
    return cfg.replace(qk_kept=ncfg.qk_kept,
                       d_inner_kept=ncfg.d_inner_kept), out


def prune_deepseek_phase(dev, launches):
    """CORP of deepseek-v3-671b at full width and 4 layers (seeded bf16
    weights, the port-only Zipf stream, 256 sequences of 512 in batches
    of 4): 0.5/0.5 two-pass, compensated and plain. Gated: J* <= J_uncomp,
    the kept sizes, the launches (``gram`` 5 a pass-1 batch: 3 dense
    taps, the expert queues, the shared expert; attention 4 a forward),
    peak device memory <= 76 GB; on the dense model's inputs, the dense
    MLPs' compensated held-out error <= plain, and the MoE blocks'
    (routed + shared) on calibration tokens (an expert sees ~4 rows a
    kept channel: tests/moe_ridge_witness.py). Reported: stage times,
    traversals, rows a kept channel, the MLA-only prune's held-out
    logits, compensated and plain. The compensated model is served in
    process between the two prunes (``[serve pruned deepseek]``).
    Held-out logits are the bf16 model's (30 GB do not fit twice in
    fp32)."""
    import torch
    from repro_torch.core import PruneConfig
    from repro_torch.models import mlp as mlp_mod
    model, params = big_lm("deepseek-v3-671b", dev, DEEPSEEK["layers"])
    cfg = model.cfg
    calib, held = lm_calib(cfg, dev, seed=29, spec=DEEPSEEK)
    dense = logits_bf16(cfg, params, held)
    sp = DEEPSEEK["sparsity"]
    batches = DEEPSEEK["seqs"] // DEEPSEEK["batch"]
    tokens = DEEPSEEK["seqs"] * DEEPSEEK["seq"]
    m = cfg.moe
    C = mlp_mod.capacity(DEEPSEEK["batch"] * DEEPSEEK["seq"], cfg)
    expert_rows = min(tokens * m.top_k / m.num_experts, C * batches)
    print(f"[prune deepseek] corp_prune of deepseek-v3-671b at "
          f"{cfg.n_layers} layers ({cfg.layout()}), {DEEPSEEK['seqs']} "
          f"sequences of {DEEPSEEK['seq']} tokens in {batches} batches of "
          f"{DEEPSEEK['batch']} (port-only Zipf stream), sparsity {sp}/{sp}; "
          f"rows a kept channel: dense {tokens / (cfg.dense_d_ff * sp):.1f}, "
          f"an expert ~{expert_rows / (m.d_expert * sp):.1f} ({C} slots a "
          f"batch), shared {tokens / (m.num_shared * m.d_expert * sp):.1f}")
    seen = {"tokens": torch.cat([b["tokens"] for b in
                                 itertools.islice(calib(), 4)])}
    errs = {}
    for comp in (True, False):
        tag = "prune deepseek" + ("" if comp else " no-compensate")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        new, ncfg, rep, ran, _, err = lm_prune_run(
            tag, model, params, calib, held, dense,
            PruneConfig(sp, sp, compensate=comp), evaluate=logits_bf16)
        peak = torch.cuda.max_memory_allocated()
        mixer = new["seg1"]["p0"]["mixer"]
        shared = new["seg1"]["p0"]["mlp"]["shared"]
        half = (cfg.qk_full // 2, cfg.dense_d_ff // 2, m.d_expert // 2)
        if (ncfg.eff_qk, ncfg.eff_dense_d_ff, ncfg.eff_d_expert) != half \
                or mixer["w_uq_nope"].shape[-1] != half[0] \
                or mixer["w_uk_nope"].shape[-1] != half[0] \
                or shared["wd"].shape[-2] != half[2] \
                or new["seg0"]["l0"]["mlp"]["wd"].shape[0] != half[1]:
            fail(f"{tag}: kept sizes qk {ncfg.eff_qk}, dense d_ff "
                 f"{ncfg.eff_dense_d_ff}, d_expert {ncfg.eff_d_expert}")
        # pass 1: one gram a dense layer, the expert queues, the shared
        # expert; attention once a layer in each pass's forward
        if ran["gram"] != (cfg.first_k_dense + 2) * batches \
                or ran["flash_attention"] != 2 * cfg.n_layers * batches:
            fail(f"{tag}: {ran['gram']} gram launches (want "
                 f"{cfg.first_k_dense + 2} a pass-1 batch), "
                 f"{ran['flash_attention']} attention launches")
        if peak > 76e9:
            fail(f"{tag}: peak device memory {peak / 1e9:.1f} GB > 76 GB")
        if comp:
            launches["prune_deepseek"] = ran
            t0 = time.time()
            launches["serve_pruned_deepseek"] = serve_in_process(
                DEEPSEEK_PRUNED_SERVE, "serve pruned deepseek", ncfg, new,
                ("seg0/l0/mlp/bd", "seg1/p0/mlp/bd_moe",
                 "seg1/p0/mlp/shared/bd"), ("flash_attention",))
            print(f"[serve pruned deepseek] phase wall "
                  f"{time.time() - t0:.3f} s")
        acfg, aparams = mixers_only(cfg, params, ncfg, new)
        errs[comp] = dict(
            logits=err, held=block_errors(cfg, params, ncfg, new, held),
            seen=block_errors(cfg, params, ncfg, new, seen),
            mla_only=rel_err(logits_bf16(acfg, aparams, held), dense))
        e = errs[comp]
        print(f"[{tag}] peak device memory {peak / 1e9:.1f} GB (gate 76); "
              f"the blocks' output errors on held-out inputs "
              + ", ".join(f"{k} {v:.4f}" for k, v in e["held"].items())
              + "; on 4 calibration batches "
              + ", ".join(f"{k} {v:.4f}" for k, v in e["seen"].items())
              + f"; MLA-only held-out logits {e['mla_only']:.4f}")
        del new, mixer, shared, aparams
    c, p = errs[True], errs[False]
    print(f"[prune deepseek] held-out logits |pruned - dense| / |dense| "
          f"compensated {c['logits']:.4f}, no-compensate {p['logits']:.4f}; "
          f"MLA only compensated {c['mla_only']:.4f}, no-compensate "
          f"{p['mla_only']:.4f}; dense MLPs held out {c['held']['dense']:.4f}"
          f" / {p['held']['dense']:.4f}; MoE blocks on calibration tokens "
          f"{c['seen']['moe']:.4f} / {p['seen']['moe']:.4f}, held out "
          f"{c['held']['moe']:.4f} / {p['held']['moe']:.4f}")
    if not c["held"]["dense"] <= p["held"]["dense"]:
        fail("prune deepseek: on held-out tokens the compensated dense MLPs "
             "are not closer to the dense ones than the plain prune's")
    if not c["seen"]["moe"] <= p["seen"]["moe"]:
        fail("prune deepseek: on calibration tokens the compensated MoE "
             "blocks are not closer to the dense ones than the plain "
             "prune's: the fold is not what the ridge solved")
    del params, dense
    torch.cuda.empty_cache()


def reference_prune_cases(tag, cases):
    """Reduced configs (fp32) through ``launch.prune --calib-seq 16 --out``
    on the GPU and the CPU, for each (arch, prune flags, serve flags) of
    ``cases``:
    pruned logits within 1e-3 (8 patch embeddings before a VLM's tokens,
    24 frames beside an enc-dec's);
    then the GPU's checkpoint through ``launch.serve --ckpt-in`` on both:
    equal streams, and every compensation leaf restored equal to the
    prune's."""
    import torch
    from repro_torch.interop import flatten
    from repro_torch.launch import prune, serve
    from repro_torch.models import build_model
    for arch, extra, serve_extra in cases:
        logits, comp = {}, {}
        for device in ("cuda", "cpu"):
            out = f"{OUT}_{arch}_{device}"
            res = prune.main(["--arch", arch, "--sparsity", "0.5",
                              "--calib-seq", "16", "--device", device,
                              "--out", out] + extra)
            pcfg = res["pruned_cfg"]
            toks = torch.arange(2 * 24, dtype=torch.int32).reshape(2, 24) \
                % pcfg.vocab_size
            batch = {"tokens": toks}
            if pcfg.frontend == "patch_stub":
                batch["patch_embeds"] = torch.randn(
                    (2, 8, pcfg.d_model),
                    generator=torch.Generator().manual_seed(1))
            if pcfg.family == "encdec":
                batch["frames"] = torch.randn(
                    (2, 24, pcfg.d_model),
                    generator=torch.Generator().manual_seed(1))
            batch = {k: v.to(device) for k, v in batch.items()}
            logits[device] = build_model(pcfg).apply(
                res["pruned_params"], batch)[0].cpu()
            comp[device] = {k: v.cpu() for k, v in
                            flatten(res["pruned_params"]).items()
                            if k.endswith(serve.COMPENSATION_LEAVES)}
        err = rel_err(logits["cuda"], logits["cpu"])
        print(f"[{tag}] {arch} {' '.join(extra)}: pruned "
              f"({pcfg.eff_d_ff if pcfg.moe is None else pcfg.eff_d_expert}"
              f" channels" + (f", {pcfg.eff_num_experts} experts"
                              if pcfg.moe is not None else "")
              + f", qk {pcfg.eff_qk}) logits GPU vs CPU relative error "
              f"{err:.3e} (tol 1e-3)")
        if not err <= 1e-3:
            fail(f"{arch}: the pruned model on the GPU disagrees with the "
                 f"CPU's plain path")
        streams = {}
        for device in ("cuda", "cpu"):
            res = serve.main(["--arch", arch, "--sparsity", "0.5",
                              "--ckpt-in", f"{OUT}_{arch}_cuda"]
                             + serve_extra + SERVE_REDUCED[2:]
                             + ["--device", device])
            streams[device] = [c.tokens.tolist() for c in res["completions"]]
            got = flatten(res["params"])
            if not comp["cuda"] or not all(
                    torch.equal(got[k].cpu(), v)
                    for k, v in comp["cuda"].items()):
                fail(f"{arch}: the compensation leaves were not restored "
                     f"from the checkpoint")
        same = streams["cuda"] == streams["cpu"]
        print(f"[{tag}] {arch} {' '.join(extra)} pruned checkpoint served "
              f"with its {len(comp['cuda'])} compensation leaves restored, "
              f"GPU vs CPU streams: {sum(map(len, streams['cuda']))} tokens, "
              f"{'identical' if same else 'DIFFERENT'}")
        if not same:
            fail(f"{arch}: the pruned model's streams on the GPU differ from "
                 f"the CPU's")


def deepseek_reference_phase():
    """The reduced deepseek-v3-671b (fp32; 1 dense and 2 MoE layers, MLA)
    on the GPU against the CPU's plain path: a prefill and 4 decode steps
    from the latent cache (logits within 1e-3), the dense engine's streams,
    and ``launch.prune`` two-pass, with ``--expert-sparsity 0.5`` and with
    ``--one-traversal`` (margin 1.0, a hit), each checkpoint served through
    ``--ckpt-in`` (``reference_prune_cases``). One traversal is not run
    at full width: its class-1 host reconstruction holds (ds^2)^2 float64
    a head, 68.7 GB at MLA's 128 heads of ds 64."""
    import torch
    from repro_torch.configs import resolve_config
    from repro_torch.models import build_model
    arch = "deepseek-v3-671b-reduced"
    cfg = resolve_config(arch)
    model = build_model(cfg)
    toks = (torch.arange(2 * 20, dtype=torch.int32).reshape(2, 20) * 13) \
        % cfg.vocab_size
    out = {}
    for device in ("cuda", "cpu"):
        params = model.init(torch.Generator().manual_seed(0), device)
        logits, cache = model.prefill(
            params, {"tokens": toks[:, :16].to(device)}, 64,
            lengths=torch.tensor([16, 11], device=device))
        rows = [logits[:, 0]]
        for i in range(16, 20):
            logits, cache = model.decode_step(
                params, toks[:, i:i + 1].to(device), cache)
            rows.append(logits[:, 0])
        out[device] = torch.stack(rows).cpu()
    err = rel_err(out["cuda"], out["cpu"])
    print(f"[reference deepseek] {arch}: ragged prefill (16, 11) and 4 "
          f"decode steps from the latent cache, logits GPU vs CPU relative "
          f"error {err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        fail("reference deepseek: MLA prefill and decode on the GPU "
             "disagree with the CPU's plain path")
    serve_reference_phase(["--arch", arch] + SERVE_REDUCED[2:],
                          "reference deepseek")
    experts = ["--expert-sparsity", "0.5"]
    reference_prune_cases("reference deepseek", [
        (arch, [], []), (arch, experts, experts),
        (arch, ["--one-traversal", "--spec-margin", "1.0"], [])])


def deepseek_phases(dev, rows, launches):
    """The deepseek-v3-671b phases in order, each timed; their launches
    are added to ``launches``."""
    import torch
    for tag, fn in (
            ("kernels deepseek", lambda: deepseek_kernel_phase(dev, rows)),
            ("serve deepseek",
             lambda: launches.update(serve_deepseek_phase(dev))),
            ("prune deepseek", lambda: prune_deepseek_phase(dev, launches)),
            ("reference deepseek", deepseek_reference_phase)):
        t0 = time.time()
        fn()
        torch.cuda.empty_cache()
        print(f"[{tag}] phase wall {time.time() - t0:.3f} s")


# ---------------------------------------------------------------------------
# jamba-1.5-large-398b (Mamba hybrid: 7 Mamba layers to 1 attention layer,
# GQA 64/8, a MoE of 16 experts of 24576, top 2, on every odd layer)
# ---------------------------------------------------------------------------

# full width at 5 of its 72 layers (48.1 GB of bf16 weights, drawn on the
# card): Mamba 0-3 and the attention layer 4, MoE on 1 and 3, the shallowest
# cut that holds the attention layer
JAMBA_SERVE = ["--arch", "jamba-1.5-large-398b", "--n-layers", "5"] \
    + BIG_TRACE
# its prune at 2 layers (24.4 GB: layer 0 Mamba + dense GLU, layer 1 Mamba +
# MoE), the serve model's first two layers: 256 sequences of 512 Zipf
# tokens in batches of 4 (one routing group of 2048 tokens, 320 slots an
# expert)
JAMBA = dict(sparsity=0.5, seqs=256, seq=512, batch=4, held=2, layers=2)
JAMBA_PRUNED_SERVE = ["--arch", "jamba-1.5-large-398b", "--n-layers", "2",
                      "--sparsity", "0.5"] + BIG_TRACE
# host memory the prune needs free: its pass-1 moments (the MoE layer's
# 16 x 24576^2 fp32, 38.7 GB, the dense and Mamba taps' 4.6 GB) wait there
# between ranking and the fold
JAMBA_HOST_BYTES = 48e9


def jamba_kernel_phase(dev, rows):
    """The kernels at the shapes jamba's paths give them: causal GQA
    ``flash_attention`` at 64/8 (B 4, T 512, d 128; pruned q/k 64 against
    v 128) in bf16; ``flash_decode`` at group 8 (8 slots of S 2048, dense
    and pruned); ``gram`` at the dense GLU tap (1, 2048, 24576), a Mamba
    ``mamba_y`` tap (1, 2048, 16384) and one expert queue (1, 320, 24576),
    the launches of a pass-1 batch, and over 4 expert queues at once, whose
    4 x 24576^2 outputs pass 2^31 (int64 offsets); each against its plain
    version, timed beside its bound and the one-call PyTorch
    equivalent."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.flash_decode import ops as decode_ops
    from repro_torch.kernels.flash_decode import ref as decode_ref
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram import ref as gram_ref
    by_name = {row["name"]: row for row in rows}
    g = torch.Generator(device=dev).manual_seed(31)
    bf = torch.bfloat16

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    print("[kernels jamba] the kernels against their plain versions at the "
          "jamba-1.5-large-398b shapes")
    B, T, H, Hkv, dv = 4, 512, 64, 8, 128
    scale = 128 ** -0.5
    for dq, tag in ((128, "jamba_prefill"), (64, "jamba_prefill_pruned")):
        q, k = rand(B, T, H, dq, dtype=bf), rand(B, T, Hkv, dq, dtype=bf)
        v = rand(B, T, Hkv, dv, dtype=bf)
        err = check_attention(q, k, v, True, None, scale,
                              f"{tag} group {H // Hkv}", tol=2e-2)
        qt = q.transpose(1, 2)
        kt, vt = (a.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                  for a in (k, v))
        library = "SDPA"
        try:
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           scale=scale)
        except RuntimeError:        # a backend that needs dq == dv
            qt, kt = (F.pad(a, (0, dv - dq)) for a in (qt, kt))
            library = f"SDPA, q and k padded to {dv}"
        calls = {"ms": lambda: flash_ops.attention(q, k, v, causal=True,
                                                   scale=scale),
                 "plain_ms": lambda: flash_ref.attention(
                     q, k, v, causal=True, scale=scale),
                 "library_ms": lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, is_causal=True, scale=scale)}
        r = {"shape": [B, T, H, Hkv, dq, dv], "max_abs_err": err,
             "library": library,
             **{key: device_ms(fn, reps=10) for key, fn in calls.items()}}
        r["bound_ms"], r["bound_by"] = bound_ms(
            2.0 * B * H * visible_keys(T, None) * (dq + dv),
            2 * B * T * (H * (dq + dv) + Hkv * (dq + dv)), PEAK_BF16_FLOPS)
        print(f"  flash_attention {tag} B={B} T={T} H={H}/{Hkv} dq={dq} "
              f"dv={dv} bf16 causal, device time: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, {library} "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
        by_name["flash_attention"][tag] = r
        del q, k, v, qt, kt, vt

    B, S = 8, 2048
    lens = torch.tensor([64 + 70 * i for i in range(B)], device=dev)
    valid = torch.arange(S, device=dev)[None] < lens[:, None]
    keys = int(valid.sum())
    for dq in (128, 64):
        q = rand(B, H, dq, dtype=bf)
        k, v = rand(B, S, Hkv, dq, dtype=bf), rand(B, S, Hkv, dv, dtype=bf)
        tag = f"jamba_decode_{dq}_{dv}"
        err = check_decode(q, k, v, valid, tag, 2e-2)
        kt, vt = (a.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                  for a in (k, v))
        qt, m4 = q[:, :, None], valid[:, None, None, :]
        calls = {"ms": lambda: decode_ops.decode_attention(
                     q, k, v, valid, scale=scale),
                 "plain_ms": lambda: decode_ref.decode_attention(
                     q, k, v, valid, scale),
                 "library_ms": lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, attn_mask=m4, scale=scale)}
        r = {"shape": [B, S, H, Hkv, dq, dv], "valid_keys": keys,
             "max_abs_err": err,
             **{key: device_ms(fn) for key, fn in calls.items()}}
        r["bound_ms"], r["bound_by"] = bound_ms(
            2.0 * H * keys * (dq + dv),
            keys * Hkv * (dq + dv) * 2 + 2 * B * H * (dq + dv) + B * S,
            PEAK_BF16_FLOPS)
        print(f"  flash_decode {tag} group {H // Hkv} ({keys} valid keys of "
              f"{B * S}), device time: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        by_name["flash_decode"][tag] = r
        del q, k, v, kt, vt

    queues = rand(4, 320, 24576)
    queues[:, 256:] = 0.0          # the queues' empty capacity slots
    check_gram(queues, label="4 expert queues, > 2^31")
    del queues
    torch.cuda.empty_cache()
    one = rand(1, 320, 24576)
    one[:, 256:] = 0.0
    for x, tag, label in ((rand(1, 4 * 512, 24576), "jamba_dense",
                           "dense GLU tap"),
                          (rand(1, 4 * 512, 16384), "jamba_mamba",
                           "Mamba mamba_y tap"),
                          (one, "jamba_expert", "one expert queue")):
        err = check_gram(x, label=label)
        s2 = gram_ops.gram(x)["s2"]
        if not torch.equal(s2, s2.mT):
            fail(f"gram {label}: s2 is not exactly symmetric")
        del s2
        r = {"shape": list(x.shape), "max_abs_err": err,
             "ms": time_ms(lambda: gram_ops.gram(x), reps=3, warmup=1),
             "plain_ms": time_ms(lambda: gram_ref.gram(x), reps=3,
                                 warmup=1),
             "library_ms": time_ms(lambda: torch.matmul(x.mT, x), reps=3,
                                   warmup=1)}
        L, N, Fd = x.shape
        r["bound_ms"], r["bound_by"] = bound_ms(
            1.0 * L * N * Fd * (Fd + 1),
            4.0 * (L * N * Fd + L * Fd * Fd + L * Fd))
        print(f"  gram at the {label} shape {tuple(x.shape)} fp32: kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"torch.matmul {r['library_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
        by_name["gram"][tag] = r
        del x
        torch.cuda.empty_cache()
    del one


def serve_jamba_phase():
    """jamba-1.5-large-398b at full width and 5 layers through
    ``launch.serve`` under the recurrent contract: every request served;
    ``flash_attention`` once a prefill and ``flash_decode`` once a decode
    or walk step (the one attention layer), gated exactly; a slot's bytes
    split into the Mamba states and the attention K/V. Returns ({path:
    launches}, the CLI's result)."""
    from repro_torch.serve import ServeEngine
    launches, res = serve_phase(JAMBA_SERVE, "serve jamba",
                                ("flash_attention", "flash_decode"))
    cfg = res["model"].cfg
    arg = dict(zip(JAMBA_SERVE[::2], JAMBA_SERVE[1::2]))
    if [len(c.tokens) for c in res["completions"]] \
            != [r.gen for r in cli_trace(arg, cfg)]:
        fail("serve jamba: a request did not complete")

    def calls(st):
        steps = st.get("decode_steps", 0) + st.get("walk_steps", 0)
        return sum(v for k, v in st.items() if k.startswith("prefill_b")), \
            steps
    warm, trace = calls(res["warmup_stats"]), calls(res["stats"])
    attn = cfg.layer_kinds.count("attn")
    need = (attn * (warm[0] + trace[0]), attn * (warm[1] + trace[1]))
    print(f"[serve jamba] {cfg.n_layers} layers ({cfg.layer_kinds}); "
          f"flash_attention {launches['flash_attention']} launches == "
          f"{need[0]} (prefills), flash_decode {launches['flash_decode']} "
          f"== {need[1]} (decode and walk steps), x {attn} attention layer")
    if (launches["flash_attention"], launches["flash_decode"]) != need:
        fail("serve jamba: the attention kernels' launches do not match "
             "the prefills and steps")
    max_len = int(arg["--max-len"])
    parts = {n: ServeEngine(res["model"], res["params"], n_slots=1,
                            max_len=n).slotcache.slot_parts
             for n in (max_len // 2, max_len)}
    mamba = cfg.layer_kinds.count("mamba")
    p = parts[max_len]
    print(f"[serve jamba] slot bytes at max_len {max_len}: Mamba states "
          f"{p['state']} ({p['state'] / mamba / 1e6:.3f} MB a layer, "
          f"{mamba} layers), attention K/V {p['kv']} ({attn} layer); at "
          f"max_len {max_len // 2}: states {parts[max_len // 2]['state']}, "
          f"K/V {parts[max_len // 2]['kv']}")
    if parts[max_len // 2]["state"] != p["state"] \
            or not parts[max_len // 2]["kv"] < p["kv"]:
        fail("serve jamba: the Mamba states grow with max_len, or the K/V "
             "rows do not")
    return {"serve_jamba": launches}, res


def host_free_bytes():
    """MemAvailable of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    fail("no MemAvailable in /proc/meminfo")


def prune_jamba_phase(dev, served, launches):
    """CORP of jamba-1.5-large-398b at full width and 2 layers, the served
    model's first two layers (layers 2-4 freed): 0.5 of the Mamba inner
    channels, the dense GLU's and each expert's channels (attention has no
    layer here), compensated and plain, on 256 sequences of 512 Zipf
    tokens in batches of 4. Refuses to start when the host has less than
    ``JAMBA_HOST_BYTES`` free (the pass-1 moments wait there before the
    fold). Gated: J* <= J_uncomp, the kept sizes, ``gram`` 19 launches a
    pass-1 batch (2 Mamba taps, the dense tap, 16 expert queues), the
    compensation leaves, peak device memory <= 76 GB; on the dense model's
    inputs the Mamba and dense blocks' compensated held-out error <=
    plain, and the MoE blocks' on calibration tokens (~1.3 rows a kept
    expert channel: the ridge is underdetermined held out). Reported:
    stage times, rows a kept channel of every unit, the Mamba-only
    prune's held-out logits, compensated and plain. The compensated model
    is served in process (``[serve pruned jamba]``)."""
    import torch
    from repro_torch.core import PruneConfig
    from repro_torch.models import build_model
    from repro_torch.models import mlp as mlp_mod
    free = host_free_bytes()
    print(f"[prune jamba] host memory available {free / 1e9:.1f} GB "
          f"(needs {JAMBA_HOST_BYTES / 1e9:.0f})")
    if free < JAMBA_HOST_BYTES:
        fail(f"prune jamba: the host has {free / 1e9:.1f} GB free, less "
             f"than the {JAMBA_HOST_BYTES / 1e9:.0f} GB the parked MoE "
             f"moments need")
    full = served["params"]
    cfg = served["model"].cfg.replace(n_layers=JAMBA["layers"])
    params = {k: v for k, v in full.items() if not k.startswith("seg")}
    params["seg0"] = {f"l{j}": full["seg0"][f"l{j}"]
                      for j in range(cfg.n_layers)}
    served.clear()
    del full
    torch.cuda.empty_cache()
    model = build_model(cfg)
    calib, held = lm_calib(cfg, dev, seed=37, spec=JAMBA)
    dense = logits_bf16(cfg, params, held)
    sp = JAMBA["sparsity"]
    batches = JAMBA["seqs"] // JAMBA["batch"]
    tokens = JAMBA["seqs"] * JAMBA["seq"]
    m = cfg.moe
    C = mlp_mod.capacity(JAMBA["batch"] * JAMBA["seq"], cfg)
    expert_rows = min(tokens * m.top_k / m.num_experts, C * batches)
    print(f"[prune jamba] corp_prune of jamba-1.5-large-398b at "
          f"{cfg.n_layers} layers ({cfg.layout()}, {cfg.layer_kinds}), "
          f"{JAMBA['seqs']} sequences of {JAMBA['seq']} tokens in {batches} "
          f"batches of {JAMBA['batch']} (port-only Zipf stream), sparsity "
          f"{sp}; rows a kept channel: Mamba "
          f"{tokens / (cfg.eff_d_inner * sp):.1f}, dense "
          f"{tokens / (cfg.d_ff * sp):.1f}, an expert "
          f"~{expert_rows / (m.d_expert * sp):.2f} ({C} slots a batch)")
    seen = {"tokens": torch.cat([b["tokens"] for b in
                                 itertools.islice(calib(), 4)])}
    errs = {}
    for comp in (True, False):
        tag = "prune jamba" + ("" if comp else " no-compensate")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        new, ncfg, rep, ran, logits, err = lm_prune_run(
            tag, model, params, calib, held, dense,
            PruneConfig(sp, sp, compensate=comp), evaluate=logits_bf16)
        # nothing made after this run's moments were parked may outlive it:
        # the next run's 38.7 GB of expert moments need one free block
        del logits
        peak = torch.cuda.max_memory_allocated()
        l0, l1 = new["seg0"]["l0"], new["seg0"]["l1"]
        half = (cfg.eff_d_inner // 2, cfg.d_ff // 2)
        if (ncfg.eff_d_inner, ncfg.eff_d_ff) != half \
                or l0["mixer"]["out_proj"].shape[0] != half[0] \
                or l1["mixer"]["in_proj"].shape[1] != 2 * half[0] \
                or l0["mlp"]["wd"].shape[0] != half[1] \
                or l1["mlp"]["wd"].shape[1] != half[1] \
                or ("out_b" in l1["mixer"]) != comp:
            fail(f"{tag}: kept sizes d_inner {ncfg.eff_d_inner}, d_ff "
                 f"{ncfg.eff_d_ff}, or out_b")
        # pass 1: a gram launch a Mamba tap (2), the dense tap (1) and each
        # of the 16 expert queues (one 24576^2 fp32 s2 is 2.4 GB): 19
        per_batch = 2 + 1 + 16
        if ran["gram"] != per_batch * batches:
            fail(f"{tag}: {ran['gram']} gram launches (want {per_batch} a "
                 f"pass-1 batch: 2 Mamba taps, the dense tap, the 16 "
                 f"expert queues)")
        if peak > 76e9:
            fail(f"{tag}: peak device memory {peak / 1e9:.1f} GB > 76 GB")
        if comp:
            launches["prune_jamba"] = ran
            t0 = time.time()
            launches["serve_pruned_jamba"] = serve_in_process(
                JAMBA_PRUNED_SERVE, "serve pruned jamba", ncfg, new,
                ("seg0/l0/mixer/out_b", "seg0/l1/mixer/out_b",
                 "seg0/l0/mlp/bd", "seg0/l1/mlp/bd_moe"), ())
            print(f"[serve pruned jamba] phase wall {time.time() - t0:.3f} s")
        mcfg, mparams = mixers_only(cfg, params, ncfg, new)
        errs[comp] = dict(
            logits=err,
            held=block_errors(cfg, params, ncfg, new, held),
            seen=block_errors(cfg, params, ncfg, new, seen),
            mamba_only=rel_err(logits_bf16(mcfg, mparams, held), dense))
        e = errs[comp]
        print(f"[{tag}] peak device memory {peak / 1e9:.1f} GB (gate 76); "
              f"the blocks' output errors on held-out inputs "
              + ", ".join(f"{k} {v:.4f}" for k, v in e["held"].items())
              + "; on 4 calibration batches "
              + ", ".join(f"{k} {v:.4f}" for k, v in e["seen"].items())
              + f"; Mamba-only held-out logits {e['mamba_only']:.4f}")
        del new, l0, l1, mparams
    c, p = errs[True], errs[False]
    print(f"[prune jamba] held-out logits |pruned - dense| / |dense| "
          f"compensated {c['logits']:.4f}, no-compensate {p['logits']:.4f}; "
          f"Mamba only compensated {c['mamba_only']:.4f}, no-compensate "
          f"{p['mamba_only']:.4f}; Mamba blocks held out "
          f"{c['held']['mamba']:.4f} / {p['held']['mamba']:.4f}; dense MLP "
          f"held out {c['held']['dense']:.4f} / {p['held']['dense']:.4f}; "
          f"MoE blocks on calibration tokens {c['seen']['moe']:.4f} / "
          f"{p['seen']['moe']:.4f}, held out {c['held']['moe']:.4f} / "
          f"{p['held']['moe']:.4f}")
    for kind in ("mamba", "dense"):
        if not c["held"][kind] <= p["held"][kind]:
            fail(f"prune jamba: on held-out tokens the compensated {kind} "
                 f"blocks are not closer to the dense ones than the plain "
                 f"prune's")
    if not c["seen"]["moe"] <= p["seen"]["moe"]:
        fail("prune jamba: on calibration tokens the compensated MoE "
             "blocks are not closer to the dense ones than the plain "
             "prune's: the fold is not what the ridge solved")
    del params, dense
    torch.cuda.empty_cache()


def jamba_reference_phase():
    """The reduced jamba (fp32; 8 layers, Mamba and attention, dense and MoE
    MLPs) on the GPU against the CPU's plain path: a prefill of 300 tokens
    (two scan chunks) and 4 decode steps (logits within 1e-3), the dense
    engine's streams, and ``launch.prune`` two-pass and with
    ``--one-traversal`` (margin 1.0, a hit on ``gram_cross``: the class-2
    attention unit), each checkpoint served through ``--ckpt-in`` with its
    ``mixer/out_b`` restored (``reference_prune_cases``)."""
    import torch
    from repro_torch.configs import resolve_config
    from repro_torch.models import build_model
    arch = "jamba-1.5-large-398b-reduced"
    cfg = resolve_config(arch)
    model = build_model(cfg)
    toks = (torch.arange(2 * 304, dtype=torch.int32).reshape(2, 304) * 13) \
        % cfg.vocab_size
    out = {}
    for device in ("cuda", "cpu"):
        params = model.init(torch.Generator().manual_seed(0), device)
        logits, cache = model.prefill(
            params, {"tokens": toks[:, :300].to(device)}, 320)
        rows = [logits[:, 0]]
        for i in range(300, 304):
            logits, cache = model.decode_step(
                params, toks[:, i:i + 1].to(device), cache)
            rows.append(logits[:, 0])
        out[device] = torch.stack(rows).cpu()
    err = rel_err(out["cuda"], out["cpu"])
    print(f"[reference jamba] {arch}: prefill of 300 tokens and 4 decode "
          f"steps, logits GPU vs CPU relative error {err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        fail("reference jamba: the Mamba hybrid's prefill and decode on the "
             "GPU disagree with the CPU's plain path")
    serve_reference_phase(["--arch", arch] + SERVE_REDUCED[2:],
                          "reference jamba")
    reference_prune_cases("reference jamba", [
        (arch, [], []),
        (arch, ["--one-traversal", "--spec-margin", "1.0"], [])])


def jamba_phases(dev, rows, launches):
    """The jamba-1.5-large-398b phases in order, each timed; their launches
    are added to ``launches``."""
    import torch
    t0 = time.time()
    jamba_kernel_phase(dev, rows)
    print(f"[kernels jamba] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    ran, served = serve_jamba_phase()
    launches.update(ran)
    print(f"[serve jamba] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    prune_jamba_phase(dev, served, launches)
    del served
    torch.cuda.empty_cache()
    print(f"[prune jamba] phase wall {time.time() - t0:.3f} s (with [serve "
          f"pruned jamba])")
    t0 = time.time()
    jamba_reference_phase()
    print(f"[reference jamba] phase wall {time.time() - t0:.3f} s")


# ---------------------------------------------------------------------------
# seamless-m4t-large-v2 (the encoder-decoder: 24 encoder and 24 decoder
# layers, d 1024, MHA 16/16 of 64, relu^2 MLP of 8192, LayerNorm, sinusoidal
# positions; vocabulary 256,206)
# ---------------------------------------------------------------------------

# full width and depth (1.632 G parameters, 3.26 GB in bf16): short decoder
# prompts against 512 encoder frames, the output the long part, as in
# speech translation
SEAMLESS_SERVE = ["--arch", "seamless-m4t-large-v2", "--trace", "16",
                  "--slots", "8", "--max-len", "1024", "--mem-len", "512",
                  "--prompt-range", "4,32", "--gen-range", "16,96",
                  "--init-on-device"]
# its prune in fp32 (6.53 GB): 128 sequences of 512 Zipf tokens, each with
# 512 frames drawn on the card, in batches of 8 (16 rows a kept MLP
# channel; at 64 sequences, 8 rows, a Cholesky of the MLP ridge fails; the
# logits of a batch of 16 would take 8.4 GB)
SEAMLESS = dict(sparsity=0.5, seqs=128, seq=512, batch=8, held=4)
SEAMLESS_PRUNED_SERVE = ["--arch", "seamless-m4t-large-v2", "--trace", "8",
                         "--slots", "8", "--max-len", "1024", "--mem-len",
                         "512", "--prompt-range", "4,32", "--gen-range",
                         "16,96"]


def encdec_attention(cfg):
    """``flash_attention`` launches of an enc-dec forward: each encoder
    layer's self-attention, each decoder layer's self and cross
    attention."""
    return cfg.n_enc_layers + 2 * cfg.n_layers


def seamless_kernel_phase(dev, rows):
    """The kernels at the shapes seamless-m4t-large-v2's paths give them:
    ``flash_attention`` non-causal at T != S (cross attention: a decoder
    prompt of 32 against 512 frames, as a serve prefill, and 700 rows
    against 512), MHA 16/16, q/k 64 and pruned 32 against v 64, at the
    dense model's scale 1/sqrt(64) passed in, fp32 and bf16, and at the
    calibration forward's cross attention (B 8, T = S = 512, fp32);
    ``flash_decode`` over an all-valid memory of 500 rows (not a 64-key
    tile multiple), 8 slots, dense and pruned, bf16 and fp32; ``gram`` at
    the stacked MLP tap of a calibration batch (24, 4096, 8192) fp32. Each
    against its plain version, timed beside its bound and SDPA or
    ``torch.matmul``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.flash_decode import ops as decode_ops
    from repro_torch.kernels.flash_decode import ref as decode_ref
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.gram import ref as gram_ref
    by_name = {row["name"]: row for row in rows}
    g = torch.Generator(device=dev).manual_seed(41)
    bf, f32 = torch.bfloat16, torch.float32

    def rand(*shape, dtype=f32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    print("[kernels seamless] the kernels against their plain versions at "
          "the seamless-m4t-large-v2 shapes")
    H, dv, scale = 16, 64, 64 ** -0.5
    cases = [(1, 32, 512, dq, dt) for dt in (bf, f32) for dq in (64, 32)] \
        + [(2, 700, 512, dq, dt) for dt in (bf, f32) for dq in (64, 32)] \
        + [(8, 512, 512, 64, f32)]
    for B, T, S, dq, dtype in cases:
        name = str(dtype)[6:]
        tag = (f"seamless_cross_{T}x{S}_{dq}_{dv}"
               + ("" if dtype == bf else "_fp32"))
        q, k = rand(B, T, H, dq, dtype=dtype), rand(B, S, H, dq, dtype=dtype)
        v = rand(B, S, H, dv, dtype=dtype)
        err = check_attention(q, k, v, False, None, scale,
                              f"cross {T}x{S} {dq}/{dv} {name}",
                              tol=2e-2 if dtype == bf else 1e-4)
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        library = "SDPA"
        try:
            F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        except RuntimeError:        # a backend that needs dq == dv
            qt, kt = (F.pad(a, (0, dv - dq)) for a in (qt, kt))
            library = f"SDPA, q and k padded to {dv}"
        calls = {"ms": lambda: flash_ops.attention(q, k, v, causal=False,
                                                   scale=scale),
                 "plain_ms": lambda: flash_ref.attention(
                     q, k, v, causal=False, scale=scale),
                 "library_ms": lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, scale=scale)}
        r = {"shape": [B, T, S, H, H, dq, dv], "dtype": name,
             "max_abs_err": err, "library": library,
             **{key: device_ms(fn, reps=10) for key, fn in calls.items()}}
        size = q.element_size()
        r["bound_ms"], r["bound_by"] = bound_ms(
            2.0 * B * H * T * S * (dq + dv),
            size * (B * T * H * (dq + dv) + B * S * H * (dq + dv)),
            PEAK_BF16_FLOPS if dtype == bf else PEAK_FP32_FLOPS)
        print(f"  flash_attention {tag} B={B} T={T} S={S} H={H} dq={dq} "
              f"dv={dv} {name} non-causal, device time: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, {library} "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
        by_name["flash_attention"][tag] = r
        del q, k, v, qt, kt, vt

    B, S = 8, 500
    valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    for dtype in (bf, f32):
        for dq in (64, 32):
            name = str(dtype)[6:]
            q = rand(B, H, dq, dtype=dtype)
            k, v = rand(B, S, H, dq, dtype=dtype), rand(B, S, H, dv,
                                                       dtype=dtype)
            tag = f"seamless_cross_decode_{dq}_{dv}" \
                + ("" if dtype == bf else "_fp32")
            err = check_decode(q, k, v, valid, tag,
                               2e-2 if dtype == bf else 1e-4, scale=scale)
            qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
            m4 = valid[:, None, None, :]
            calls = {"ms": lambda: decode_ops.decode_attention(
                         q, k, v, valid, scale=scale),
                     "plain_ms": lambda: decode_ref.decode_attention(
                         q, k, v, valid, scale),
                     "library_ms": lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, attn_mask=m4, scale=scale)}
            r = {"shape": [B, S, H, H, dq, dv], "dtype": name,
                 "valid_keys": B * S, "max_abs_err": err,
                 **{key: device_ms(fn) for key, fn in calls.items()}}
            size = q.element_size()
            r["bound_ms"], r["bound_by"] = bound_ms(
                2.0 * B * H * S * (dq + dv),
                size * (B * S * H * (dq + dv) + B * H * (dq + dv)) + B * S,
                PEAK_BF16_FLOPS if dtype == bf else PEAK_FP32_FLOPS)
            print(f"  flash_decode {tag} ({B} slots of {S} memory rows, all "
                  f"valid) {name}, device time: kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, SDPA "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
            by_name["flash_decode"][tag] = r
            del q, k, v, qt, kt, vt

    x = rand(24, 4096, 8192)
    err = check_gram(x, label="seamless MLP tap")
    s2 = gram_ops.gram(x)["s2"]
    if not torch.equal(s2, s2.mT):
        fail("gram seamless MLP tap: s2 is not exactly symmetric")
    del s2
    torch.cuda.empty_cache()
    r = {"shape": list(x.shape), "max_abs_err": err,
         "ms": time_ms(lambda: gram_ops.gram(x), reps=3, warmup=1),
         "plain_ms": time_ms(lambda: gram_ref.gram(x), reps=3, warmup=1),
         "library_ms": time_ms(lambda: torch.matmul(x.mT, x), reps=3,
                               warmup=1)}
    L, N, Fd = x.shape
    r["bound_ms"], r["bound_by"] = bound_ms(
        1.0 * L * N * Fd * (Fd + 1), 4.0 * (L * N * Fd + L * Fd * Fd + L * Fd))
    print(f"  gram at the seamless MLP tap {tuple(x.shape)} fp32: kernel "
          f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, torch.matmul "
          f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
          f"({r['bound_by']})")
    by_name["gram"]["seamless_mlp"] = r
    del x
    torch.cuda.empty_cache()


def serve_seamless_phase():
    """seamless-m4t-large-v2 at full width and depth through
    ``launch.serve --mem-len 512``: every request served;
    ``flash_attention`` 72 times a prefill (the encoder's, the decoder's
    and the cross attention of each of 24 layers) and ``flash_decode`` 48
    times a decode step (the decoder's self and cross attention), gated
    exactly; a slot's bytes split into the decoder's K/V and the memory's.
    Returns ({path: launches}, the CLI's result)."""
    from repro_torch.serve import ServeEngine
    launches, res = serve_phase(SEAMLESS_SERVE, "serve seamless",
                                ("flash_attention", "flash_decode"))
    cfg = res["model"].cfg
    arg = dict(zip(SEAMLESS_SERVE[::2], SEAMLESS_SERVE[1::2]))
    if [len(c.tokens) for c in res["completions"]] \
            != [r.gen for r in cli_trace(arg, cfg)]:
        fail("serve seamless: a request did not complete")

    def calls(st):
        return sum(v for k, v in st.items() if k.startswith("prefill_b")), \
            st.get("decode_steps", 0) + st.get("walk_steps", 0)
    warm, trace = calls(res["warmup_stats"]), calls(res["stats"])
    need = (encdec_attention(cfg) * (warm[0] + trace[0]),
            2 * cfg.n_layers * (warm[1] + trace[1]))
    print(f"[serve seamless] {cfg.n_enc_layers} + {cfg.n_layers} layers; "
          f"flash_attention {launches['flash_attention']} launches == "
          f"{need[0]} ({encdec_attention(cfg)} a prefill), flash_decode "
          f"{launches['flash_decode']} == {need[1]} ({2 * cfg.n_layers} a "
          f"decode step)")
    if (launches["flash_attention"], launches["flash_decode"]) != need:
        fail("serve seamless: the attention kernels' launches do not match "
             "the prefills and steps")
    max_len, mem_len = int(arg["--max-len"]), int(arg["--mem-len"])
    parts = ServeEngine(res["model"], res["params"], n_slots=1,
                        max_len=max_len, mem_len=mem_len).slotcache \
        .slot_parts
    row = cfg.n_layers * cfg.n_kv_heads * (cfg.eff_qk + cfg.d_head) * 2
    print(f"[serve seamless] slot bytes: decoder self K/V {parts['self']} "
          f"({max_len} rows), memory K/V {parts['memory']} ({mem_len} "
          f"rows), {row} a row of the 24 layers")
    if parts["memory"] != mem_len * row \
            or parts["self"] != max_len * row + 4 * (cfg.n_layers + 1):
        fail("serve seamless: the slot's bytes are not the decoder's and "
             "the memory's K/V rows")
    return {"serve_seamless": launches}, res


def seamless_calib(cfg, dev, seed):
    """``lm_calib``'s Zipf tokens, each sequence with as many frames
    (standard normals, drawn on the card) for the encoder: the port-only
    stand-in for the reference's enc-dec stream, whose Markov table is
    256,206^2 x 4 B = 262 GB at seamless's vocabulary."""
    import torch
    calib, held = lm_calib(cfg, dev, seed=seed, spec=SEAMLESS)
    g = torch.Generator(device=dev).manual_seed(seed + 2)

    def frames(b):
        return torch.randn((b, SEAMLESS["seq"], cfg.d_model), generator=g,
                           device=dev)
    batches = [dict(b, frames=frames(len(b["tokens"]))) for b in calib()]
    return (lambda: iter(batches)), dict(
        held, frames=frames(len(held["tokens"])))


def seamless_partial(cfg, ncfg, params, new, parts):
    """The dense model with only ``parts`` of each layer pruned (CORP takes
    every statistic from the dense model, so these are the blocks'
    prune alone): (stack, param key) pairs, e.g. ("dec", "cross"). The
    forward reads each attention's qk dims from its weights; the MLP's
    come from the config (``ncfg``'s when the MLPs are pruned)."""
    out = dict(params)
    for seg in ("enc", "dec"):
        out[seg] = {"p0": dict(params[seg]["p0"], **{
            key: new[seg]["p0"][key] for s, key in parts if s == seg})}
    if any(key == "mlp" for _, key in parts):
        cfg = cfg.replace(d_ff_kept=ncfg.d_ff_kept)
    return cfg, out


def prune_seamless_phase(dev, served, launches):
    """CORP of seamless-m4t-large-v2 at full width and depth in fp32 (the
    served model's weights): 0.5/0.5 two-pass on 128 sequences of 512
    Zipf tokens and 512 frames, batches of 8, compensated and plain.
    Gated: J* <= J_uncomp, the kept sizes (d_ff 4096, qk 32 in the
    encoder's, the decoder's and the cross attention), ``gram`` 2 a
    pass-1 batch (the encoder's and the decoder's stacked MLP taps),
    ``flash_attention`` 72 a forward in each pass; held out, the MLP
    units' prune alone closer to the dense model compensated than plain.
    Reported: stage times, traversals, peak device memory, held-out
    logits of the whole prune and of the cross unit's prune alone
    (class 1 on a decoder query against memory keys; not gated) and of
    the self-attention units' alone. The compensated model is served in
    process (``[serve pruned seamless]``)."""
    import torch
    from repro_torch.core import PruneConfig
    from repro_torch.interop import map_tree
    from repro_torch.models import build_model
    cfg = served["model"].cfg.replace(dtype="float32")
    params = map_tree(lambda t: t.float(), served["params"])
    served.clear()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    calib, held = seamless_calib(cfg, dev, seed=43)
    dense = logits32(cfg, params, held)
    sp = SEAMLESS["sparsity"]
    batches = SEAMLESS["seqs"] // SEAMLESS["batch"]
    tokens = SEAMLESS["seqs"] * SEAMLESS["seq"]
    print(f"[prune seamless] corp_prune of seamless-m4t-large-v2 at full "
          f"width and depth ({cfg.n_enc_layers} + {cfg.n_layers} layers, "
          f"fp32), {SEAMLESS['seqs']} sequences of {SEAMLESS['seq']} tokens "
          f"and {SEAMLESS['seq']} frames in {batches} batches of "
          f"{SEAMLESS['batch']} (port-only Zipf stream, frames drawn on the "
          f"card), sparsity {sp}/{sp}; rows a kept MLP channel "
          f"{tokens / (cfg.d_ff * sp):.1f}")
    errs = {}
    for comp in (True, False):
        tag = "prune seamless" + ("" if comp else " no-compensate")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        new, ncfg, rep, ran, logits, err = lm_prune_run(
            tag, model, params, calib, held, dense,
            PruneConfig(sp, sp, compensate=comp))
        del logits
        peak = torch.cuda.max_memory_allocated()
        half = (cfg.d_ff // 2, cfg.qk_full // 2)
        shapes = {k: tuple(new[s]["p0"][b][w].shape) for k, (s, b, w) in {
            "enc_wq": ("enc", "mixer", "wq"), "dec_wk": ("dec", "mixer", "wk"),
            "cross_wq": ("dec", "cross", "wq"),
            "cross_wk": ("dec", "cross", "wk"),
            "dec_wd": ("dec", "mlp", "wd")}.items()}
        if (ncfg.eff_d_ff, ncfg.eff_qk) != half \
                or any(v[-1] != half[1] for k, v in shapes.items()
                       if k != "dec_wd") \
                or shapes["dec_wd"][1] != half[0]:
            fail(f"{tag}: kept sizes d_ff {ncfg.eff_d_ff}, qk {ncfg.eff_qk}, "
                 f"leaves {shapes}")
        want = (2 * batches, 2 * encdec_attention(cfg) * batches)
        if (ran["gram"], ran["flash_attention"]) != want:
            fail(f"{tag}: {ran['gram']} gram and {ran['flash_attention']} "
                 f"flash_attention launches (want {want}: 2 MLP taps a "
                 f"pass-1 batch, {encdec_attention(cfg)} attention a "
                 f"forward)")
        if comp:
            launches["prune_seamless"] = ran
            t0 = time.time()
            launches["serve_pruned_seamless"] = serve_in_process(
                SEAMLESS_PRUNED_SERVE, "serve pruned seamless", ncfg, new,
                ("enc/p0/mlp/bd", "dec/p0/mlp/bd"),
                ("flash_attention", "flash_decode"))
            print(f"[serve pruned seamless] phase wall "
                  f"{time.time() - t0:.3f} s")
        e = {"logits": err, "peak": peak}
        for key, parts in (("mlp", (("enc", "mlp"), ("dec", "mlp"))),
                           ("cross", (("dec", "cross"),)),
                           ("self_attn", (("enc", "mixer"),
                                          ("dec", "mixer")))):
            pcfg, pparams = seamless_partial(cfg, ncfg, params, new, parts)
            e[key] = rel_err(logits32(pcfg, pparams, held), dense)
            del pparams
        errs[comp] = e
        print(f"[{tag}] peak device memory {peak / 1e9:.1f} GB; held-out "
              f"|pruned - dense| / |dense| of fp32 logits: whole "
              f"{err:.4f}, MLP units alone {e['mlp']:.4f}, cross unit "
              f"alone {e['cross']:.4f}, self-attention units alone "
              f"{e['self_attn']:.4f}")
        del new
    c, p = errs[True], errs[False]
    print(f"[prune seamless] held-out logits compensated / no-compensate: "
          f"whole {c['logits']:.4f} / {p['logits']:.4f}; MLP units alone "
          f"{c['mlp']:.4f} / {p['mlp']:.4f}; cross unit alone "
          f"{c['cross']:.4f} / {p['cross']:.4f} (class 1 on the cross "
          f"block: reported, not gated); self-attention alone "
          f"{c['self_attn']:.4f} / {p['self_attn']:.4f}")
    if not c["mlp"] <= p["mlp"]:
        fail("prune seamless: on held-out inputs the compensated MLP units "
             "are not closer to the dense model than the plain prune's")
    del params, dense
    torch.cuda.empty_cache()


def seamless_reference_phase():
    """The reduced seamless-m4t-large-v2 (fp32; 2 + 2 layers) on the GPU
    against the CPU's plain path: a ragged prefill (16 and 11 tokens
    against 24 frames) and 4 decode steps (logits within 1e-3), the
    engine's streams with ``--mem-len 16``, and ``launch.prune`` two-pass
    and with ``--one-traversal`` (margin 1.0, a hit), each checkpoint
    served through ``--ckpt-in --mem-len`` (``reference_prune_cases``)."""
    import torch
    from repro_torch.configs import resolve_config
    from repro_torch.models import build_model
    arch = "seamless-m4t-large-v2-reduced"
    cfg = resolve_config(arch)
    model = build_model(cfg)
    toks = (torch.arange(2 * 20, dtype=torch.int32).reshape(2, 20) * 13) \
        % cfg.vocab_size
    frames = torch.randn((2, 24, cfg.d_model),
                         generator=torch.Generator().manual_seed(3))
    out = {}
    for device in ("cuda", "cpu"):
        params = model.init(torch.Generator().manual_seed(0), device)
        logits, cache = model.prefill(
            params, {"frames": frames.to(device),
                     "tokens": toks[:, :16].to(device)}, 64,
            lengths=torch.tensor([16, 11], device=device))
        rows = [logits[:, 0]]
        for i in range(16, 20):
            logits, cache = model.decode_step(
                params, toks[:, i:i + 1].to(device), cache)
            rows.append(logits[:, 0])
        out[device] = torch.stack(rows).cpu()
    err = rel_err(out["cuda"], out["cpu"])
    print(f"[reference seamless] {arch}: ragged prefill (16, 11) against 24 "
          f"frames and 4 decode steps, logits GPU vs CPU relative error "
          f"{err:.3e} (tol 1e-3)")
    if not err <= 1e-3:
        fail("reference seamless: the enc-dec's prefill and decode on the "
             "GPU disagree with the CPU's plain path")
    mem = ["--mem-len", "16"]
    serve_reference_phase(["--arch", arch] + mem + SERVE_REDUCED[2:],
                          "reference seamless")
    reference_prune_cases("reference seamless", [
        (arch, [], mem),
        (arch, ["--one-traversal", "--spec-margin", "1.0"], mem)])


def seamless_phases(dev, rows, launches):
    """The seamless-m4t-large-v2 phases in order, each timed; their
    launches are added to ``launches``."""
    import torch
    t0 = time.time()
    seamless_kernel_phase(dev, rows)
    print(f"[kernels seamless] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    ran, served = serve_seamless_phase()
    launches.update(ran)
    print(f"[serve seamless] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    prune_seamless_phase(dev, served, launches)
    del served
    torch.cuda.empty_cache()
    print(f"[prune seamless] phase wall {time.time() - t0:.3f} s (with "
          f"[serve pruned seamless])")
    t0 = time.time()
    seamless_reference_phase()
    print(f"[reference seamless] phase wall {time.time() - t0:.3f} s")


# ---------------------------------------------------------------------------
# training: the attention backward kernel and the train path
# ---------------------------------------------------------------------------

# the backward kernel at the shapes the train path and the other families
# give it: B, T, S, H, Hkv, dq, dv, causal, window, dtype
TRAIN_KERNEL_CASES = [
    ("DeiT-Base", (32, 197, 197, 12, 12, 64, 64, False, None, "float32")),
    ("Qwen2-1.5B", (4, 512, 512, 12, 2, 128, 128, True, None, "bfloat16")),
    ("gemma3-1b", (4, 1024, 1024, 4, 1, 256, 256, True, 512, "bfloat16")),
    ("MLA", (1, 512, 512, 128, 128, 192, 128, True, None, "bfloat16")),
    ("cross", (8, 32, 512, 16, 16, 64, 64, False, None, "float32")),
]
# DeiT-Base through the train CLI; Qwen2-1.5B at 4 of its 28 layers, full
# width, bf16, on Zipf tokens (the CLI's Markov table is V x V)
TRAIN = dict(arch="deit-base", steps=8, batch=32, save_every=4,
             cpu_batch=8, lm_arch="qwen2-1.5b", lm_layers=4, lm_batch=4,
             lm_seq=512, lm_steps=3, rwkv_arch="rwkv6-3b", rwkv_layers=4)
# the wkv6 backward kernel: B, T, H, N, dtype, an initial state (and a
# final state's gradient), w's lower end; (a) is RWKV6-3B's train shape
WKV6_BWD_CASES = [
    ("(a) RWKV6-3B train", (4, 512, 40, 64, "bfloat16", False, 0.35)),
    ("(b) ragged, state", (2, 200, 8, 64, "float32", True, 0.35)),
    ("(c) T=1", (2, 1, 8, 64, "float32", True, 0.35)),
    ("(c) T=63", (2, 63, 8, 64, "float32", True, 0.35)),
    ("(c) T=64", (2, 64, 8, 64, "float32", True, 0.35)),
    ("(c) T=65", (2, 65, 8, 64, "float32", True, 0.35)),
    ("(d) small decay", (2, 130, 8, 64, "float32", True, 1e-4)),
]
# one value_and_grad step of each family's reduced config, card against CPU
TRAIN_ZOO = ["rwkv6-3b", "qwen3-moe-235b-a22b", "deepseek-v3-671b",
             "jamba-1.5-large-398b", "seamless-m4t-large-v2"]


def ptxas_report(source, prefix):
    """(kernel, registers, (spill store bytes, spill load bytes)) of each
    kernel whose name starts with ``prefix`` that ``nvcc -Xptxas -v``
    compiled from ``source`` in this process's build
    (``_build.build_log``; empty for a cached build), named with its
    template's two ints, e.g. ``bwd_dq_bf16<128, 128>``."""
    from repro_torch.kernels import _build
    part = _build.build_log.partition(f"== {source}\n")[2]
    part = part.split("\n== ")[0]
    out, fn, spill = [], None, (0, 0)
    for line in part.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(rf"(?<=\d)({prefix}[a-z0-9_]*?)"
                          rf"(?:ILi(\d+)ELi(\d+)E|E)",
                          m.group(1))
            fn = m.group(1) if t is None else t.group(1) if t.group(2) is \
                None else f"{t.group(1)}<{t.group(2)}, {t.group(3)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            out.append((fn, int(m.group(1)), spill))
            fn, spill = None, (0, 0)
    return out


def train_kernel_phase(dev, rows):
    """``[kernels train]``: the attention backward kernel against its plain
    version (``ref.attention_bwd`` on the plain logsumexp) and against
    autograd through ``ref.attention``, at each case of
    ``TRAIN_KERNEL_CASES``, with its time beside the plain version's,
    SDPA's backward and the bound; appends the ``flash_attention_bwd``
    row (numbers of the DeiT-Base case, the others under ``cases``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import backward as flash_bwd
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref

    g = torch.Generator(device=dev).manual_seed(7)
    print("[kernels train] flash_attention backward against its plain "
          "version and autograd through the plain forward")
    spilled = []
    for fn, regs, spill in ptxas_report("flash_attention_bwd.cu", "bwd_"):
        print(f"  ptxas flash_attention_bwd: {fn} {regs} registers, spill "
              f"stores/loads {spill[0]}/{spill[1]} bytes")
        if any(spill):
            spilled.append(fn)
    if spilled:
        fail(f"flash_attention_bwd instances spill: {spilled}")
    cases = []
    for tag, (B, T, S, H, Hkv, dq, dv, causal, window, dt) in \
            TRAIN_KERNEL_CASES:
        dtype = getattr(torch, dt)
        tol = 1e-4 if dtype == torch.float32 else 2e-2

        def rand(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)
        q, k, v, do = rand(B, T, H, dq), rand(B, S, Hkv, dq), \
            rand(B, S, Hkv, dv), rand(B, T, H, dv)
        scale = dq ** -0.5
        kw = dict(causal=causal, window=window, scale=scale)
        o, lse = flash_ops._forward(q, k, v, causal, window, scale,
                                    with_lse=True)
        lse_ref = flash_ref.logsumexp(q, k, **kw)
        lse_err = float((lse - lse_ref).abs().max())
        pl = flash_bwd.Plan(B, T, S, H, Hkv, dq, dv, causal, window, dtype)
        print(f"  flash_attention_bwd {tag} plan: instance {pl.instance}, "
              f"streamed tiles of {pl.stream} rows, dK/dV grid "
              f"{pl.grid_kv} x {pl.threads_kv} threads, {pl.smem_kv} B; dQ "
              f"grid {pl.grid_q} x {pl.threads_q} threads, {pl.smem_q} B")
        got = flash_bwd.attention_bwd(q, k, v, o, lse, do, **kw)
        again = flash_bwd.attention_bwd(q, k, v, o, lse, do, **kw)
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        want = flash_ref.attention_bwd(
            q, k, v, flash_ref.attention(q, k, v, **kw), lse_ref, do, **kw)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(flash_ref.attention(*leaves, **kw),
                                   leaves, do)
        errs, rels = [], []
        for a, b, c in zip(got, want, auto):
            for ref_g in (b, c):
                e = float((a.float() - ref_g.float()).abs().max())
                errs.append(e)
                rels.append(e / float(ref_g.float().abs().max()))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        ok = finite and bitwise and max(rels) <= tol and lse_err <= 1e-3
        print(f"  flash_attention_bwd {tag:<11} B={B} T={T} S={S} H={H}/"
              f"{Hkv} dq={dq} dv={dv} causal={causal} window={window} {dt}:"
              f" dq/dk/dv max rel err {max(rels):.3e} (vs plain "
              f"{max(rels[0::2]):.3e}, vs autograd {max(rels[1::2]):.3e}; "
              f"tol {tol:g} of max |grad|), lse err {lse_err:.2e}, two "
              f"calls {'bitwise equal' if bitwise else 'DIFFER'} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash_attention_bwd {tag} disagrees with its plain "
                 f"version or is not deterministic")
        del leaves, auto, want
        # timing: the kernel, the plain version, SDPA's backward (kv heads
        # repeated to H, a mask for the window)
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt, vt = (a.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
                  .detach().requires_grad_() for a in (k, v))
        mask = flash_ref._mask(T, S, causal, window, dev)
        if not causal and window is None:
            sdpa_kw = {}
        elif window is None and T == S:
            sdpa_kw = dict(is_causal=True)
        else:
            sdpa_kw = dict(attn_mask=mask)
        out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                             **sdpa_kw)
        dot = do.transpose(1, 2)
        reps = 10
        row = {"case": tag, "shape": [B, T, S, H, Hkv, dq, dv],
               "causal": causal, "window": window, "dtype": dt,
               "instance": list(pl.instance), "grids": [pl.grid_kv,
                                                         pl.grid_q],
               "smem": [pl.smem_kv, pl.smem_q],
               "max_abs_err": max(errs[0::2]), "max_rel_err": max(rels),
               "ms": time_ms(lambda: flash_bwd.attention_bwd(
                   q, k, v, o, lse, do, **kw), reps=reps),
               "plain_ms": time_ms(lambda: flash_ref.attention_bwd(
                   q, k, v, o, lse, do, **kw), reps=3, warmup=1),
               "library_ms": time_ms(lambda: torch.autograd.grad(
                   out, (qt, kt, vt), dot, retain_graph=True), reps=reps),
               "fwd_ms": time_ms(lambda: flash_ops._forward(
                   q, k, v, causal, window, scale), reps=reps)}
        pairs = float(mask.sum()) * B * H
        es = q.element_size()
        nbytes = es * (2 * B * T * H * dq + 2 * B * S * Hkv * dq
                       + 2 * B * S * Hkv * dv + 2 * B * T * H * dv) \
            + 4.0 * B * H * T
        row["bound_ms"], row["bound_by"] = bound_ms(
            2.0 * pairs * (3 * dq + 2 * dv), nbytes,
            PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS)
        print(f"    device time: kernel {row['ms']:.3f} ms (forward "
              f"{row['fwd_ms']:.3f} ms), plain {row['plain_ms']:.3f} ms, "
              f"SDPA backward {row['library_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        cases.append(row)
        del q, k, v, do, o, lse, lse_ref, got, qt, kt, vt, out, dot, mask
    torch.cuda.empty_cache()
    main = cases[0]
    rows.append({"name": "flash_attention_bwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/flash_attention/csrc/"
                           "flash_attention_bwd.cu",
                 "replaces": "src/repro/kernels/flash_attention/"
                             "flash_attention.py:73",
                 "note": "the gradient of that kernel, which has no Pallas "
                         "backward (JAX differentiates its jnp paths)",
                 "launches": None, "max_abs_err": main["max_abs_err"],
                 "ms": main["ms"], "plain_ms": main["plain_ms"],
                 "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                 "library_ms": main["library_ms"], "cases": cases})
    rows.append(wkv6_bwd_kernel_phase(dev))


def wkv6_bwd_flops(B, T, H, N):
    """fp32 operations the gradient needs, by its plain reverse recurrence:
    per token and head, the forward's state recomputed (3 N^2: diag(w) S +
    k v^T), dr = S dy, dk = dS v, dv = dS^T k, dw = rowsum(dS * S) (2 N^2
    each), dS' = diag(w) dS + r dy^T (3 N^2); the O(N) terms v . dy (2 N),
    the bonus sum u r k (3 N), its dr, dk, dv terms (3 N, 3 N, 2 N) and du
    (3 N): 14 N^2 + 16 N in all."""
    return float((14 * N * N + 16 * N) * B * T * H)


def wkv6_bwd_bytes(B, T, H, N, itemsize, state):
    """r, k, v, w, dy read and dr, dk, dv, dw written once in their dtype,
    u read and du written in fp32; with a state, it and the final state's
    gradient read and the initial state's gradient written in fp32."""
    return (9 * B * T * H * N * itemsize + 8 * H * N
            + (12 * B * H * N * N if state else 0))


def wkv6_bwd_kernel_phase(dev):
    """``[kernels train]``: the wkv6 backward kernel against its plain
    version (``ref.wkv6_bwd``) and against autograd through ``ref.wkv6``
    at each case of ``WKV6_BWD_CASES`` (fp32 <= 1e-4, bf16 <= 2e-2 of each
    gradient's max |g|), two calls bitwise equal at (a), and (a) timed
    beside the forward, the plain version and the bound; returns the
    ``wkv6_bwd`` row (numbers of case (a), the others under ``cases``)."""
    import torch
    from repro_torch.kernels.wkv6 import backward as wkv_bwd
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref

    g = torch.Generator(device=dev).manual_seed(29)
    print("[kernels train] wkv6 backward against its plain version and "
          "autograd through the plain forward")
    names = ("dr", "dk", "dv", "dw", "du", "dstate0")
    cases = []
    for tag, (B, T, H, N, dt, state, w_lo) in WKV6_BWD_CASES:
        dtype = getattr(torch, dt)
        tol = 1e-4 if dtype == torch.float32 else 2e-2

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev)
        r, k, v, dy = (randn(B, T, H, N).to(dtype) for _ in range(4))
        w = (w_lo + (0.95 - w_lo) * torch.rand((B, T, H, N), generator=g,
                                               device=dev)).to(dtype)
        u = 0.1 * randn(H, N)
        s0, ds = (randn(B, H, N, N), randn(B, H, N, N)) if state \
            else (None, None)
        _, _, starts = wkv_ops._forward(r, k, v, w, u, s0, None)
        got = wkv_bwd.wkv6_bwd(r, k, v, w, u, s0, dy, ds, starts=starts)
        want = wkv_ref.wkv6_bwd(r, k, v, w, u, s0, dy, ds)
        leaves = [t.detach().clone().requires_grad_()
                  for t in (r, k, v, w, u, s0) if t is not None]
        yy, ss = wkv_ref.wkv6(*leaves) if state \
            else wkv_ref.wkv6(*leaves, None)
        auto = torch.autograd.grad((yy, ss) if state else yy, leaves,
                                   (dy, ds) if state else dy)
        del yy, ss, leaves
        errs, rels = {}, []
        for name, a, b, c in zip(names, got, want, auto):
            m = float(b.float().abs().max())
            e_plain = float((a.float() - b.float()).abs().max())
            e_auto = float((a.float() - c.float()).abs().max())
            errs[name] = e_plain
            rels.append((e_plain / m, e_auto / m))
        finite = all(bool(torch.isfinite(a).all())
                     for a in got if a is not None)
        dtypes = [a.dtype for a in got if a is not None] \
            == [dtype] * 4 + [torch.float32] * (2 if state else 1)
        worst = max(max(x) for x in rels)
        ok = finite and dtypes and worst <= tol
        print(f"  wkv6_bwd {tag:<20} B={B} T={T} H={H} N={N} {dt} "
              f"state={state} w in ({w_lo:g}, 0.95): max rel err "
              f"{worst:.3e} (vs plain {max(x[0] for x in rels):.3e}, vs "
              f"autograd {max(x[1] for x in rels):.3e}; tol {tol:g} of "
              f"max |grad|) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"wkv6_bwd {tag} disagrees with its plain version")
        row = {"case": tag, "shape": [B, T, H, N], "dtype": dt,
               "state": state, "w_lo": w_lo, "max_abs_err": max(
                   errs.values()), "max_abs_err_by_grad": errs,
               "max_rel_err": worst}
        if tag.startswith("(a)"):
            again = wkv_bwd.wkv6_bwd(r, k, v, w, u, s0, dy, ds,
                                     starts=starts)
            same = all(bool(torch.equal(a, b))
                       for a, b in zip(got, again) if a is not None)
            print(f"  wkv6_bwd {tag}: two calls bitwise equal: "
                  f"{'ok' if same else 'FAIL'}")
            if not same:
                fail("wkv6_bwd is not deterministic")
            del again
            row["ms"] = time_ms(lambda: wkv_bwd.wkv6_bwd(
                r, k, v, w, u, s0, dy, ds, starts=starts), reps=10)
            row["fwd_ms"] = time_ms(lambda: wkv_ops._forward(
                r, k, v, w, u, s0, None), reps=10)
            row["plain_ms"] = time_ms(lambda: wkv_ref.wkv6_bwd(
                r, k, v, w, u, s0, dy, ds), reps=2, warmup=1)
            row["bound_ms"], row["bound_by"] = bound_ms(
                wkv6_bwd_flops(B, T, H, N),
                wkv6_bwd_bytes(B, T, H, N, r.element_size(), state))
            row["blocks"] = wkv_bwd.Plan(B, T, H, N).blocks
            print(f"    device time: kernel {row['ms']:.4f} ms (forward "
                  f"keeping its starts {row['fwd_ms']:.4f} ms), plain "
                  f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} "
                  f"ms ({row['bound_by']}); no single PyTorch call "
                  f"computes it")
        cases.append(row)
        del r, k, v, w, dy, u, s0, ds, starts, got, want, auto
    torch.cuda.empty_cache()
    main = cases[0]
    return {"name": "wkv6_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/wkv6/csrc/wkv6_bwd.cu",
            "replaces": "src/repro/kernels/wkv6/wkv6.py:76",
            "note": "the gradient of that kernel, which has no Pallas "
                    "backward (JAX differentiates its jnp paths, "
                    "src/repro/kernels/wkv6/ops.py:33-42)",
            "launches": None, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "fwd_ms": main["fwd_ms"],
            "shape": main["shape"], "cases": cases}


def recomputed_calls(cfg):
    """A train step's calls of a layer's mixer kernel: a layer of a scanned
    segment runs twice (the forward, and its remat recompute in the
    backward), an unrolled one once."""
    return sum(2 * seg[1] * len(seg[2]) if seg[0] == "scan" else len(seg[1])
               for seg in cfg.layout())


def _grads_close(tag, want, got, tol):
    """Each leaf's gradient within ``tol`` of its max |g| (``want``'s);
    a leaf whose ``want`` is below 1e-6 of the largest gradient (an
    analytically zero one, the key bias) must be so in ``got`` too.
    Returns the worst relative error."""
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        a = got[k].float().cpu()
        m = float(w.abs().max())
        if m < 1e-6 * top:
            if float(a.abs().max()) >= 1e-6 * top:
                fail(f"{tag}: {k} gradient {float(a.abs().max())} is not "
                     f"as small as the reference's {m}")
            continue
        e = float((a - w.float()).abs().max()) / m
        worst = max(worst, e)
        if e > tol:
            fail(f"{tag}: {k} gradient differs by {e:.3e} of its max |g|")
    return worst


def train_phase(dev):
    """``[train]``: DeiT-Base at full width and depth in fp32 through
    ``python -m repro_torch.launch.train`` in process (8 steps of 32
    images, a checkpoint every 4), resumed from its step-4 checkpoint in
    another directory to step 8 (losses 5-8 within 1e-6 relative); the
    launches of run A gated exactly (24 forward and 12 backward attention
    launches a step, none of gram, flash_decode, wkv6); one step of batch
    8 on the card against the CPU from the same weights and batch;
    Qwen2-1.5B and RWKV6-3B at 4 layers (of 28, of 32), full width, bf16,
    3 steps each of B 4 x T 512 Zipf tokens, launches gated exactly (RWKV:
    wkv6 in a layer's forward and remat recompute, wkv6_bwd once a layer,
    no other kernel). Returns run A's launches, the path's numbers and the
    RWKV steps' launches."""
    import shutil
    import torch
    from repro_torch.configs import resolve_config
    from repro_torch.interop import flatten, map_tree
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, global_norm

    t = TRAIN
    base = os.path.join(OUT, "train")
    shutil.rmtree(base, ignore_errors=True)
    a_dir, b_dir = os.path.join(base, "a"), os.path.join(base, "b")
    args = ["--arch", t["arch"], "--steps", str(t["steps"]), "--batch",
            str(t["batch"]), "--save-every", str(t["save_every"])]
    print(f"[train] python -m repro_torch.launch.train {' '.join(args)} "
          f"--ckpt A")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.time()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        params_a, _, losses_a = train_mod.main(
            args + ["--ckpt", a_dir, "--log-every", "1"])
    torch.cuda.synchronize()
    wall_a = time.time() - t0
    launches = read_launches()
    print("\n".join("  " + ln for ln in log.getvalue().splitlines()))
    step_ms = [float(m) for m in re.findall(r"(\d+) ms/step", log.getvalue())]
    # the steps but the first (warm-up) and the one after a checkpoint's
    # snapshot (5: a log line's time runs to the next one)
    steady = sorted(ms for i, ms in enumerate(step_ms, 1)
                    if (i - 1) % t["save_every"])
    peak = torch.cuda.max_memory_allocated(dev)
    n = t["steps"]
    layers = resolve_config(t["arch"]).n_layers
    want = {"flash_attention": 2 * layers * n,
            "flash_attention_bwd": layers * n, "gram": 0, "gram_cross": 0,
            "flash_decode": 0, "wkv6": 0, "wkv6_bwd": 0}
    got = {k: launches.get(k, 0) for k in want}
    print(f"[train] run A: {n} steps in {wall_a:.3f} s with the init, "
          f"the data's prototypes and two checkpoints of (params, "
          f"opt_state); ms a step (the CLI's log, a float(loss) sync a "
          f"step) {step_ms}, median of the steps without a checkpoint or "
          f"warm-up {steady[len(steady) // 2]:.0f}; peak "
          f"max_memory_allocated {peak} B; losses "
          f"{[round(x, 5) for x in losses_a]}; launches {got} (want {want})")
    if got != want:
        fail(f"[train] launches {got} != {want}")
    if not all(math.isfinite(x) for x in losses_a):
        fail("[train] non-finite loss")
    os.makedirs(b_dir)
    shutil.copytree(os.path.join(a_dir, "step_00000004"),
                    os.path.join(b_dir, "step_00000004"))
    reset_launches()
    t0 = time.time()
    _, _, losses_b = train_mod.main(args + ["--ckpt", b_dir])
    torch.cuda.synchronize()
    wall_b = time.time() - t0
    tail = losses_a[t["save_every"]:]
    rel = max(abs(x - y) / abs(y) for x, y in zip(losses_b, tail))
    bitwise = losses_b == tail
    print(f"[train] run B resumed from A's step 4: losses 5-8 "
          f"{[round(x, 5) for x in losses_b]}, max rel diff to A's "
          f"{rel:.3e} (tol 1e-6), bitwise equal: {bitwise}; "
          f"{wall_b:.3f} s; launches {read_launches()['flash_attention']} "
          f"forward, {read_launches()['flash_attention_bwd']} backward")
    if len(losses_b) != len(tail) or rel > 1e-6:
        fail("[train] the resumed run's losses differ from run A's")
    shutil.rmtree(base, ignore_errors=True)

    # where a step's time goes: the host's batch against the step on the
    # card (from run A's weights, a fresh optimizer state)
    cfg = resolve_config(t["arch"])
    model = build_model(cfg)
    ocfg = AdamWConfig()
    t0 = time.time()
    batch = train_mod.data_for(cfg, n, batch=t["batch"], seq=64,
                               device=dev)
    torch.cuda.synchronize()
    data_ms = 1e3 * (time.time() - t0)
    step = train_mod.make_train_step(model, ocfg, peak_lr=3e-4,
                                     total_steps=n)
    opt = adamw_init(params_a, ocfg)
    device_step = []
    for _ in range(3):
        t0 = time.time()
        out = step(params_a, opt, batch)
        torch.cuda.synchronize()
        device_step.append(1e3 * (time.time() - t0))
    del out, opt, batch
    print(f"[train] a DeiT-Base step of {t['batch']} images: the host's "
          f"batch (numpy, to the card) {data_ms:.1f} ms; the train step "
          f"on the card (forward, remat, backward, AdamW; host clock, "
          f"synchronised) {[round(x, 1) for x in device_step]} ms")

    # one step on the card against the CPU, same weights (run A's) and
    # batch
    p_gpu = params_a
    p_cpu = map_tree(lambda x: x.cpu(), p_gpu)
    out = {}
    for name, params, device in (("gpu", p_gpu, dev), ("cpu", p_cpu, "cpu")):
        batch = train_mod.data_for(cfg, 0, batch=t["cpu_batch"], seq=64,
                                   device=device)
        t0 = time.time()
        loss, grads = train_mod.value_and_grad(
            lambda p: model.loss(p, batch), params)
        if name == "gpu":
            torch.cuda.synchronize()
        out[name] = (float(loss), float(global_norm(grads)),
                     {k: v.float().cpu() for k, v in flatten(grads).items()},
                     time.time() - t0)
    (lg, gg, grads_g, tg), (lc, gc, grads_c, tc) = out["gpu"], out["cpu"]
    loss_rel, gn_rel = abs(lg - lc) / abs(lc), abs(gg - gc) / gc
    worst = _grads_close("[train] GPU vs CPU", grads_c, grads_g, 1e-3)
    print(f"[train] GPU vs CPU, one step of {t['cpu_batch']} images from "
          f"the same weights: loss {lg:.6f} vs {lc:.6f} (rel {loss_rel:.2e}"
          f", tol 1e-4), gnorm {gg:.6f} vs {gc:.6f} (rel {gn_rel:.2e}, tol "
          f"1e-3), worst leaf {worst:.2e} of its max |g| (tol 1e-3); "
          f"value_and_grad {tg:.3f} s on the card, {tc:.3f} s on the CPU")
    if loss_rel > 1e-4 or gn_rel > 1e-3:
        fail("[train] GPU and CPU steps disagree")
    del p_cpu, p_gpu, grads_g, grads_c, out

    # Qwen2-1.5B at 4 layers, bf16, Zipf tokens
    lcfg = resolve_config(t["lm_arch"]).replace(n_layers=t["lm_layers"])
    lm = build_model(lcfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = adamw_init(params, ocfg)
    step = train_mod.make_train_step(lm, ocfg, peak_lr=3e-4,
                                     total_steps=t["lm_steps"])
    toks = zipf_tokens(lcfg.vocab_size, t["lm_batch"] * t["lm_steps"],
                       t["lm_seq"] + 1, 21, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    losses, times = [], []
    for i in range(t["lm_steps"]):
        rows_i = toks[i * t["lm_batch"]:(i + 1) * t["lm_batch"]]
        batch = {"tokens": rows_i[:, :-1], "labels": rows_i[:, 1:]}
        t0 = time.time()
        params, opt, loss, gn = step(params, opt, batch)
        losses.append(float(loss))
        times.append(time.time() - t0)
    lm_launches = read_launches()
    lm_peak = torch.cuda.max_memory_allocated(dev)
    n_lm = t["lm_steps"] * t["lm_layers"]
    lm_got = (lm_launches["flash_attention"],
              lm_launches["flash_attention_bwd"])
    print(f"[train] {t['lm_arch']} at {t['lm_layers']} of 28 layers, bf16, "
          f"B {t['lm_batch']} x T {t['lm_seq']}: losses "
          f"{[round(x, 4) for x in losses]}, step ms "
          f"{[round(1e3 * x, 1) for x in times]} (the first with the "
          f"allocator's warm-up), peak max_memory_allocated {lm_peak} B; "
          f"attention launches forward/backward {lm_got} (want "
          f"{(2 * n_lm, n_lm)})")
    if not all(math.isfinite(x) for x in losses):
        fail("[train] Qwen2 loss not finite")
    if lm_got != (2 * n_lm, n_lm):
        fail(f"[train] Qwen2 launches {lm_got}")
    del params, opt, toks

    # RWKV6-3B at 4 layers, bf16, Zipf tokens: wkv6 forward (and its
    # remat recompute) and backward
    rcfg = resolve_config(t["rwkv_arch"]).replace(n_layers=t["rwkv_layers"])
    rm = build_model(rcfg)
    params = rm.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = adamw_init(params, ocfg)
    step = train_mod.make_train_step(rm, ocfg, peak_lr=3e-4,
                                     total_steps=t["lm_steps"])
    toks = zipf_tokens(rcfg.vocab_size, t["lm_batch"] * t["lm_steps"],
                       t["lm_seq"] + 1, 22, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    r_losses, r_times = [], []
    for i in range(t["lm_steps"]):
        rows_i = toks[i * t["lm_batch"]:(i + 1) * t["lm_batch"]]
        batch = {"tokens": rows_i[:, :-1], "labels": rows_i[:, 1:]}
        t0 = time.time()
        params, opt, loss, gn = step(params, opt, batch)
        r_losses.append(float(loss))
        r_times.append(time.time() - t0)
    rwkv_launches = read_launches()
    r_peak = torch.cuda.max_memory_allocated(dev)
    r_want = {k: 0 for k in rwkv_launches if " " not in k}
    r_want.update(wkv6=recomputed_calls(rcfg) * t["lm_steps"],
                  wkv6_bwd=rcfg.n_layers * t["lm_steps"])
    r_got = {k: rwkv_launches[k] for k in r_want}
    print(f"[train] {t['rwkv_arch']} at {t['rwkv_layers']} of 32 layers, "
          f"bf16, B {t['lm_batch']} x T {t['lm_seq']}: losses "
          f"{[round(x, 4) for x in r_losses]}, step ms "
          f"{[round(1e3 * x, 1) for x in r_times]} (the first with the "
          f"allocator's warm-up), peak max_memory_allocated {r_peak} B; "
          f"launches {r_got} (want {r_want}: wkv6 a layer forward and in "
          f"the remat recompute, wkv6_bwd a layer, a step)")
    if not all(math.isfinite(x) for x in r_losses):
        fail("[train] RWKV6-3B loss not finite")
    if r_got != r_want:
        fail(f"[train] RWKV6-3B launches {r_got} != {r_want}")
    del params, opt, toks
    torch.cuda.empty_cache()
    return launches, {"deit_base": {
        "ms_per_step": step_ms, "steady_median_ms": steady[len(steady) // 2],
        "run_a_wall_s": wall_a, "peak_bytes": peak, "host_batch_ms": data_ms,
        "device_step_ms": device_step,
        "losses": losses_a, "resumed_bitwise": bitwise},
        "qwen2_4_layers": {"ms_per_step": [1e3 * x for x in times],
                           "peak_bytes": lm_peak, "losses": losses},
        "rwkv6_3b_4_layers": {"ms_per_step": [1e3 * x for x in r_times],
                              "peak_bytes": r_peak, "losses": r_losses}}, \
        rwkv_launches


def train_zoo_phase(dev):
    """``[train zoo]``: one ``value_and_grad`` step of each family's reduced
    config (``TRAIN_ZOO``, fp32, remat on) on the card against the CPU,
    from the same weights (drawn on the CPU and copied) and batch (the
    CLI's ``data_for``): loss within 1e-4 relative, gnorm 1e-3, each leaf
    within 1e-3 of its max |g| (``_grads_close``). Each family's kernel
    launches are counted and printed; RWKV's are gated exactly (wkv6 a
    layer in the forward and the recompute, wkv6_bwd a layer, no other
    kernel). Returns the launches summed over the families."""
    import torch
    from repro_torch.configs import resolve_config
    from repro_torch.interop import flatten, map_tree
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model
    from repro_torch.optim import global_norm

    total = collections.Counter()
    for arch in TRAIN_ZOO:
        cfg = resolve_config(arch + "-reduced")
        model = build_model(cfg)
        p_cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
        p_gpu = map_tree(lambda x: x.to(dev), p_cpu)
        out = {}
        for name, params, device in (("gpu", p_gpu, dev),
                                     ("cpu", p_cpu, "cpu")):
            batch = train_mod.data_for(cfg, 0, batch=2, seq=32,
                                       device=device)
            reset_launches()
            t0 = time.time()
            loss, grads = train_mod.value_and_grad(
                lambda p: model.loss(p, batch), params)
            if name == "gpu":
                torch.cuda.synchronize()
                launches = {k: n for k, n in read_launches().items()
                            if " " not in k}
            out[name] = (float(loss), float(global_norm(grads)),
                         {k: v.float().cpu()
                          for k, v in flatten(grads).items()},
                         time.time() - t0)
        (lg, gg, grads_g, tg), (lc, gc, grads_c, tc) = out["gpu"], out["cpu"]
        loss_rel, gn_rel = abs(lg - lc) / abs(lc), abs(gg - gc) / gc
        worst = _grads_close(f"[train zoo] {arch}", grads_c, grads_g, 1e-3)
        ran = {k: n for k, n in launches.items() if n}
        print(f"[train zoo] {arch}-reduced ({cfg.n_layers} layers, "
              f"{len(grads_c)} leaves): loss {lg:.6f} vs CPU {lc:.6f} (rel "
              f"{loss_rel:.2e}, tol 1e-4), gnorm {gg:.6f} vs {gc:.6f} (rel "
              f"{gn_rel:.2e}, tol 1e-3), worst leaf {worst:.2e} of its max "
              f"|g| (tol 1e-3); card {tg:.3f} s, CPU {tc:.3f} s; launches "
              f"{ran}")
        if loss_rel > 1e-4 or gn_rel > 1e-3:
            fail(f"[train zoo] {arch}: card and CPU steps disagree")
        if arch.startswith("rwkv"):
            want = {k: 0 for k in launches}
            want.update(wkv6=recomputed_calls(cfg), wkv6_bwd=cfg.n_layers)
            if launches != want:
                fail(f"[train zoo] {arch} launches {launches} != {want}")
        total.update(launches)
        del p_gpu, grads_g, out
    torch.cuda.empty_cache()
    return dict(total)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[setup] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TF32 off for matmul and cuDNN "
          f"(allow_tf32 = False)")
    t0 = time.time()
    _build.library()
    built = _build.build_seconds
    print(f"[setup] kernels ready in {time.time() - t0:.2f} s ("
          + (f"nvcc build {built:.2f} s" if built is not None
             else "cached build") + f", {_build.BUILD_DIR})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  ptxas:", line.strip())
        elif "Compiling entry function" in line:
            # the kernel's name and template arguments, mangled
            print("  ptxas:", line.split("_cu_")[-1][8:].split("'")[0])

    rows = kernel_phase(dev)
    by_name = {row["name"]: row for row in rows}
    t0 = time.time()
    lm_kernel_phase(dev, rows)
    print(f"[kernels lm prune] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    gemma_kernel_phase(dev, rows)
    print(f"[kernels gemma] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    train_kernel_phase(dev, rows)
    print(f"[kernels train] phase wall {time.time() - t0:.3f} s")
    launches = {}
    t0 = time.time()
    launches["train"], train_path, launches["train_rwkv"] = train_phase(dev)
    next(row for row in rows if row["name"] == "flash_attention_bwd")[
        "train_path"] = train_path
    print(f"[train] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    launches["train_zoo"] = train_zoo_phase(dev)
    print(f"[train zoo] phase wall {time.time() - t0:.3f} s")
    launches["prune"], held, ref, kept = main_path_phase(dev)
    t0 = time.time()
    launches["prune_bf16"], ref_bf16 = bf16_phase(held, ref)
    print(f"[main path bf16] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    launches.update(one_traversal_phase(held, {"float32": ref,
                                               "bfloat16": ref_bf16}))
    print(f"[one traversal] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    calib_ckpt_phase(dev)
    print(f"[calib ckpt] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    launches["prune_streamed"] = streamed_phase(dev, held, ref)
    print(f"[streamed] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    sharded_kernel_phase(dev, by_name)
    launches["calib_sharded"], launches["calib_sharded_moe"] = \
        calib_sharded_phase(dev, held, ref, kept)
    print(f"[calib sharded] phase wall {time.time() - t0:.3f} s")
    del held, ref, ref_bf16
    reference_phase(dev)
    profile_phase(dev)
    t0 = time.time()
    launches["serve"], served = serve_phase(
        SERVE, "serve", ("flash_attention", "flash_decode"))
    by_name["flash_decode"]["serve_step_ms"] = serve_profile_phase(
        served["model"], served["params"], dev, "serve profile",
        "flash_decode", "flash_decode_kernel")
    logit_phase(served["model"], served["params"], "logits", [40, 25])
    del served
    serve_reference_phase(SERVE_REDUCED, "reference")
    t1 = time.time()
    launches["serve_frontend"], served = serve_frontend_phase()
    print(f"[serve frontend] phase wall {time.time() - t1:.3f} s")
    t1 = time.time()
    launches.update(serve_fleet_phase(served["model"], served["params"]))
    print(f"[serve fleet] phase wall {time.time() - t1:.3f} s")
    del served
    launches["serve_rwkv"], served = serve_phase(SERVE_RWKV, "serve rwkv",
                                                 ("wkv6",))
    recurrent_checks(launches["serve_rwkv"], served)
    by_name["wkv6"]["serve_step_ms"] = serve_profile_phase(
        served["model"], served["params"], dev, "serve rwkv profile", "wkv6",
        "wkv6_step_kernel")
    logit_phase(served["model"], served["params"], "logits rwkv",
                [100, 100])
    del served
    serve_reference_phase(SERVE_RWKV_REDUCED, "reference rwkv")
    t1 = time.time()
    launches.update(serve_sharded_phase(dev))
    print(f"[serve sharded] phase wall {time.time() - t1:.3f} s")
    print(f"[serve] serve phases wall {time.time() - t0:.3f} s")
    t0 = time.time()
    lm_launches, qwen_new, qwen_cfg = prune_qwen2_phase(dev)
    launches.update(lm_launches)
    print(f"[prune qwen2] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    lm_launches, rwkv_new, rwkv_cfg = prune_rwkv_phase(dev)
    launches.update(lm_launches)
    print(f"[prune rwkv] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    launches.update(serve_pruned_phase(dev, (qwen_new, qwen_cfg),
                                       (rwkv_new, rwkv_cfg)))
    del qwen_new, rwkv_new
    print(f"[serve pruned] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    lm_reference_phase()
    print(f"[reference lm prune] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    launches.update(serve_gemma_phase(dev))
    print(f"[serve gemma] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    lm_launches, gemma_new, gemma_cfg = prune_gemma_phase(dev)
    launches.update(lm_launches)
    print(f"[prune gemma] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    launches.update(serve_pruned_gemma_phase(gemma_new, gemma_cfg))
    del gemma_new
    print(f"[serve pruned gemma] phase wall {time.time() - t0:.3f} s")
    t0 = time.time()
    gemma_reference_phase()
    print(f"[reference gemma] phase wall {time.time() - t0:.3f} s")
    internvl_moe_phases(dev, rows, launches)
    deepseek_phases(dev, rows, launches)
    jamba_phases(dev, rows, launches)
    seamless_phases(dev, rows, launches)
    for row in rows:
        row["launches_by_path"] = {path: n.get(row["name"], 0)
                                   for path, n in launches.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["name"].startswith("gram"):
            row["launches_by_path_dtype"] = {
                path: {dt: n.get(f"{row['name']} {dt}", 0)
                       for dt in ("float32", "bfloat16")}
                for path, n in launches.items()}

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
