"""Shared pieces of the port's serving front-end parity tests
(``tests/test_torch_serve_frontend*.py``): both packages' reduced models on
one set of numpy weights, a prefix cache that snapshots its entries, and a
manual-clock loop that serves one trace through either package's
front-end."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import build_model as jax_build
from repro.serve import PrefixCache as JaxPrefixCache
from repro.serve import ServeEngine as JaxEngine
from repro.serve import ServeFrontend as JaxFrontend
from repro.serve import synthetic_trace as jax_trace
from repro_torch import interop
from repro_torch.models import build_model as pt_build
from repro_torch.serve import (PrefixCache, ServeEngine, ServeFrontend,
                               synthetic_trace)
from repro_torch.serve.queue import TERMINAL
from repro_torch.serve.testing import ManualClock
from torch_parity import jax_params, lm_cfgs

SLOTS, MAX_LEN, DT = 3, 48, 0.1
TRACE = dict(seed=6, prompt_range=(2, 8), gen_range=(3, 14), rate=10.0,
             deadline_range=(0.3, 1.5), deadline_frac=0.5, prefix_len=12)
_MODELS = {}


def _models(arch):
    """Both packages' reduced model on one set of numpy weights, and one
    JAX engine (reset between runs: its jitted steps compile once)."""
    if arch not in _MODELS:
        jcfg, pcfg = lm_cfgs(arch=arch)
        params = jax_params(jcfg, seed=4)
        jm, jp = jax_build(jcfg), jax.tree.map(jnp.asarray, params)
        _MODELS[arch] = {
            "cfg": pcfg, "jeng": JaxEngine(jm, jp, n_slots=SLOTS,
                                           max_len=MAX_LEN),
            "pm": pt_build(pcfg),
            "pp": interop.from_numpy(params, device="cpu")}
    return _MODELS[arch]


class SnapshotCache(PrefixCache):
    """A ``PrefixCache`` that keeps a copy of every entry as inserted."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.snaps = {}

    def insert(self, tokens, cache, nbytes):
        key = self._key(tokens)
        if key not in self._entries:
            self.snaps[key] = interop.map_tree(torch.clone, cache)
        super().insert(tokens, cache, nbytes)

    def changed(self):
        """Keys of the entries whose tensors differ from their insert."""
        out = []
        for key, e in self._entries.items():
            got, want = interop.flatten(e.cache), \
                interop.flatten(self.snaps[key])
            if got.keys() != want.keys() or not all(
                    torch.equal(got[k], want[k]) for k in got):
                out.append(np.frombuffer(key, np.int32).tolist())
        return out


def _drive(fe, trace, clk):
    """Submit each request once the manual clock reaches its arrival, one
    front-end step per ``DT`` seconds, until every handle is terminal."""
    pending = sorted(trace, key=lambda r: (r.arrival, r.rid))
    i = 0
    for _ in range(5000):
        while i < len(pending) and pending[i].arrival <= clk():
            fe.submit(pending[i])
            i += 1
        if i == len(pending) and all(h.finished
                                     for h in fe.handles.values()):
            break
        fe.step()
        clk.advance(DT)
    return [fe.handles[r.rid] for r in sorted(trace, key=lambda r: r.rid)]


def _outcome(handles):
    return [(h.rid, h.status.value, [int(t) for t in h.tokens])
            for h in handles]


def _serve_both(arch, n, spf, chunk, cap):
    m = _models(arch)
    vocab = m["cfg"].vocab_size
    jt, pt = jax_trace(n, vocab, **TRACE), synthetic_trace(n, vocab, **TRACE)
    kw = dict(queue_depth=2, policy="spf" if spf else "fifo",
              prefill_chunk=chunk)
    jeng = m["jeng"]
    jeng.reset()
    jpc = JaxPrefixCache(cap=cap)
    jclk = ManualClock()
    want = _drive(JaxFrontend(jeng, prefix_cache=jpc, clock=jclk, **kw),
                  jt, jclk)
    eng = ServeEngine(m["pm"], m["pp"], n_slots=SLOTS, max_len=MAX_LEN)
    pc = SnapshotCache(cap=cap)
    clk = ManualClock()
    got = _drive(ServeFrontend(eng, prefix_cache=pc, clock=clk, **kw), pt,
                 clk)
    return {"want": want, "got": got, "jeng": jeng, "jpc": jpc, "eng": eng,
            "pc": pc}




def check_frontend_parity(arch, spf, chunk, n=12, cap=3):
    """Serve the trace through both packages' front-ends: equal status and
    tokens a request, every outcome of the deadline mix reached, equal
    prefix-cache counters, and every entry bitwise as inserted."""
    r = _serve_both(arch, n, spf, chunk, cap)
    got, want = _outcome(r["got"]), _outcome(r["want"])
    assert got == want
    statuses = {s for _, s, _ in got}
    assert {"done", "rejected", "expired"} <= statuses, statuses
    assert all(h.status in TERMINAL for h in r["got"])
    st, jst = r["eng"].stats, r["jeng"].stats
    for key in ("admits", "prefix_hits", "prefix_reused_tokens",
                "prefix_suffix_tokens", "cancels"):
        assert st[key] == jst[key], key
    assert st["prefix_hits"] >= 3
    assert r["pc"].stats() | {"bytes": 0} == r["jpc"].stats() | {"bytes": 0}
    assert r["pc"].evictions == r["jpc"].evictions > 0
    assert r["pc"].changed() == []
    return r
