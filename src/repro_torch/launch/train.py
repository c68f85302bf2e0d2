"""Training entry point of the port (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deit-base-reduced --steps 20 --batch 8 --device cpu \\
        --ckpt /tmp/ckpt

    PYTHONPATH=src python -m repro_torch.launch.train --arch deit-base \\
        --steps 8 --batch 32 --ckpt /tmp/ckpt

One device: AdamW with warmup-cosine (peak ``--lr``, warmup max(10,
steps / 20)) and global clipping on the loss of ``Model.loss``, whose
scanned segments are recomputed in the backward (remat) as the
reference's are. The parameters start from ``--seed`` (no pretrained
weights are in the repository); the batches are the synthetic stream,
deterministic by step (``data_for``). On the card the attention kernel
and RWKV-6's ``wkv6`` kernel run forward and backward (each backward a
hand-written kernel), so every family trains there.

Checkpoints hold ``(params, opt_state)`` under the reference's key paths
(``0/...``, ``1/m/...``, ``1/v/...``, ``1/step``), so each package resumes
from the other's; a run given a ``--ckpt`` directory with a valid step
resumes from its newest. ``--mesh`` and ``--fsdp`` (the train mesh) are
not ported and raise by name.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import resolve_config
from repro_torch.data import lm_batch, vit_batch
from repro_torch.interop import flatten, unflatten_like
from repro_torch.models import build_model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)

__all__ = ["resolve_config", "value_and_grad", "make_train_step",
           "data_for", "train", "main"]

_UNPORTED_MESH = ("the train mesh (--mesh, --fsdp) is not ported: "
                  "ROADMAP Queue 1, item '2c: the train mesh'")


def value_and_grad(loss_fn, params):
    """(loss, grads): ``grads`` has the params' tree, the gradient of
    every leaf, frozen ones included (they enter the global norm); a
    leaf the loss does not reach gets zeros, as ``jax.grad`` gives it."""
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in flatten(params).items()}
    with torch.enable_grad():
        loss = loss_fn(unflatten_like(params, leaves))
        got = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(leaves.items(), got)}
    return loss.detach(), unflatten_like(params, grads)


def make_train_step(model, ocfg, *, peak_lr, total_steps):
    """-> train_step(params, opt_state, batch) = (params, opt_state, loss,
    grad norm): one AdamW step at the schedule's rate for
    ``opt_state["step"]``."""
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(lambda p: model.loss(p, batch), params)
        lr = warmup_cosine(opt_state["step"], peak=peak_lr,
                           warmup=max(10, total_steps // 20),
                           total=total_steps)
        new_p, new_o, metrics = adamw_update(params, grads, opt_state, lr,
                                             ocfg)
        return new_p, new_o, loss, metrics["grad_norm"]
    return train_step


def data_for(cfg, step, *, batch, seq, seed=0, device=None):
    """The training batch of ``step``, as the reference makes it: images
    and labels for a ViT; Markov tokens and next-token labels for an LM,
    with the enc-dec's frames (B, seq, D) and the VLM stub's 8 patch
    embeddings drawn from their own numpy generators."""
    dev = resolve_device(device)
    if cfg.family == "vit":
        return vit_batch(step, batch=batch, img=cfg.img_size,
                         n_classes=max(2, cfg.n_classes), seed=seed,
                         device=dev)
    b = lm_batch(step, batch=batch, seq=seq, vocab=cfg.vocab_size,
                 seed=seed, device=dev)
    if cfg.family == "encdec":
        rng = np.random.RandomState(seed * 77 + step)
        b["frames"] = torch.from_numpy(
            rng.randn(batch, seq, cfg.d_model).astype(np.float32)).to(dev)
    if cfg.frontend == "patch_stub":
        rng = np.random.RandomState(seed * 79 + step)
        b["patch_embeds"] = torch.from_numpy(
            rng.randn(batch, 8, cfg.d_model).astype(np.float32)).to(dev)
    return b


def train(cfg, *, steps, batch, seq, ckpt_dir=None, mesh_shape=None,
          peak_lr=3e-4, save_every=50, log_every=10, seed=0, fsdp=False,
          log=print, device=None):
    """Train ``cfg`` from ``seed`` (or the newest checkpoint in
    ``ckpt_dir``) to ``steps``; saves every ``save_every`` steps and at
    the end. Returns (params, opt_state, the losses of the steps run)."""
    if mesh_shape or fsdp:
        raise NotImplementedError(_UNPORTED_MESH)
    dev = resolve_device(device)
    model = build_model(cfg)
    ocfg = AdamWConfig()
    params = model.init(torch.Generator().manual_seed(seed), device=dev)
    opt_state = adamw_init(params, ocfg)
    step0 = 0

    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir:
        last = latest_step(ckpt_dir)
        if last is not None:
            state, _ = restore_checkpoint(ckpt_dir, last,
                                          {"0": params, "1": opt_state})
            params, opt_state = state["0"], state["1"]
            step0 = last
            log(f"[train] resumed from step {last}")

    step_fn = make_train_step(model, ocfg, peak_lr=peak_lr,
                              total_steps=steps)
    losses = []
    t0 = time.time()
    for step in range(step0, steps):
        b = data_for(cfg, step, batch=batch, seq=seq, seed=seed, device=dev)
        params, opt_state, loss, gn = step_fn(params, opt_state, b)
        losses.append(float(loss))
        if (step + 1) % log_every == 0:
            dt = (time.time() - t0) / log_every
            log(f"[train] step {step+1}/{steps} loss {float(loss):.4f} "
                f"gnorm {float(gn):.3f} {dt*1e3:.0f} ms/step")
            t0 = time.time()
        if ckpt and ((step + 1) % save_every == 0 or step + 1 == steps):
            ckpt.save(step + 1, {"0": params, "1": opt_state})
    if ckpt:
        ckpt.wait()
    return params, opt_state, losses


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train a model of the repo on "
                                             "its synthetic stream")
    ap.add_argument("--arch", required=True,
                    help="config id; append '-reduced' for the CPU-size "
                         "variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--mesh", default=None,
                    help="not ported: raises NotImplementedError")
    ap.add_argument("--fsdp", action="store_true",
                    help="not ported: raises NotImplementedError")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10,
                    help="steps between log lines (each with ms a step)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a card) or cpu "
                         "for the plain PyTorch path")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the CLI; returns (params, opt_state, losses) for callers that
    drive it in process."""
    args = parse_args(argv)
    if args.mesh or args.fsdp:
        raise NotImplementedError(_UNPORTED_MESH)
    cfg = resolve_config(args.arch)
    params, opt_state, losses = train(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt, peak_lr=args.lr, save_every=args.save_every,
        log_every=args.log_every, seed=args.seed,
        device=resolve_device(args.device))
    if losses:
        print(f"[train] final loss {losses[-1]:.4f} "
              f"(first {losses[0]:.4f})")
    return params, opt_state, losses


if __name__ == "__main__":
    main()
