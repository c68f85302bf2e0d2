"""Does CORP's ridge compensation overfit when the calibration holds few
tokens per kept MLP channel? A CPU run of both packages, the JAX reference
and the PyTorch port, on the same weights and tokens.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/lm_overfit_witness.py

The model is Qwen2-1.5B at a quarter of its width: d_model 384, d_ff 2240,
12 query and 2 kv heads of 32, 4 layers, vocab 4096, fp32, from the JAX
init at each weight seed. Calibration is 32 or 128 sequences of 128 tokens
in batches of 8, drawn iid from the Zipf-like unigram p(v) proportional to
1 / (v + 1) that ``chip_smoke.py`` draws for its full-width LM prunes (here
with numpy, seed 11; held out: 4 sequences, seed 12). At sparsity 0.5/0.5
that is 3.66 or 14.6 tokens per kept channel, as at full width with 32 or
128 sequences of 512 tokens. Each line gives the held-out relative error
of the pruned fp32 logits to the dense ones, compensated and not.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config
from repro.core import PruneConfig as JaxPC
from repro.core import corp_prune as jax_corp_prune
from repro.models import build_model as jax_build
from repro_torch import interop
from repro_torch.core import PruneConfig, corp_prune
from repro_torch.models import build_model as pt_build
from torch_parity import lm_logits, rel, to_port_cfg

SEQ, BATCH, HELD = 128, 8, 4
SEEDS = (0, 1, 2)          # weight seeds (JAX init PRNGKey)


def quarter_qwen2():
    return get_config("qwen2-1.5b").replace(
        name="qwen2-1.5b-quarter", n_layers=4, d_model=384, d_head=32,
        d_ff=2240, vocab_size=4096, dtype="float32")


def zipf_tokens(vocab, n_seqs, seed):
    p = 1.0 / np.arange(1, vocab + 1, dtype=np.float64)
    return np.random.RandomState(seed).choice(
        vocab, size=(n_seqs, SEQ), p=p / p.sum()).astype(np.int32)


def run(jcfg, params, n_seqs):
    """{(package, compensate): held-out relative error} for one weight set
    and one calibration size."""
    toks = zipf_tokens(jcfg.vocab_size, n_seqs, 11)
    held = zipf_tokens(jcfg.vocab_size, HELD, 12)
    out = {}
    jmodel = jax_build(jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    jdense = lm_logits(jmodel, jparams, {"tokens": jnp.asarray(held)})
    jcalib = lambda: ({"tokens": jnp.asarray(toks[i:i + BATCH])}  # noqa: E731
                      for i in range(0, n_seqs, BATCH))
    pcfg = to_port_cfg(jcfg)
    pmodel = pt_build(pcfg)
    pparams = interop.from_numpy(params, device="cpu")
    pheld = {"tokens": torch.from_numpy(held)}
    pcalib = lambda: ({"tokens": torch.from_numpy(toks[i:i + BATCH])}  # noqa: E731
                      for i in range(0, n_seqs, BATCH))
    with torch.no_grad():
        pdense = lm_logits(pmodel, pparams, pheld)
    for comp in (True, False):
        pp, cfg, _ = jax_corp_prune(jmodel, jparams, jcalib,
                                    JaxPC(0.5, 0.5, compensate=comp))
        out["repro", comp] = rel(
            lm_logits(jax_build(cfg), pp, {"tokens": jnp.asarray(held)}),
            jdense)
        pp, cfg, _ = corp_prune(pmodel, pparams, pcalib,
                                PruneConfig(0.5, 0.5, compensate=comp))
        with torch.no_grad():
            out["repro_torch", comp] = rel(
                lm_logits(pt_build(cfg), pp, pheld), pdense)
    return out


def main():
    jcfg = quarter_qwen2()
    kept = jcfg.d_ff // 2
    print(f"{jcfg.name}: {jcfg.n_layers} layers, "
          f"d_ff {jcfg.d_ff} ({kept} kept), tokens of {SEQ}")
    print("| seed | seqs | tokens per kept channel | package | compensated "
          "| plain | compensated < plain |")
    print("|---|---|---|---|---|---|---|")
    for seed in SEEDS:
        params = jax.tree.map(
            lambda a: np.asarray(a, np.float32),
            jax.jit(jax_build(jcfg).init)(jax.random.PRNGKey(seed)))
        for n_seqs in (32, 128):
            errs = run(jcfg, params, n_seqs)
            for pkg in ("repro", "repro_torch"):
                c, p = errs[pkg, True], errs[pkg, False]
                print(f"| {seed} | {n_seqs} | {n_seqs * SEQ / kept:.2f} | "
                      f"{pkg} | {c:.4f} | {p:.4f} | {c < p} |", flush=True)


if __name__ == "__main__":
    main()
