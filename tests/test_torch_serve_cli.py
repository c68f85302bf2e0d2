"""The port's serve CLI with the front-end and router flags against the JAX
CLI's trace path.

``repro_torch.launch.serve --device cpu --ckpt-in DIR`` and
``repro.launch.serve.serve_trace`` serve the same trace of the reduced
qwen2-1.5b on the same numpy-made weights (a JAX checkpoint the port
restores). Each flag set must give the same table counts, the same status
and tokens a request, and the same prefix-cache stats. The runs never
depend on the clock: there is no ``--rate`` (every request arrives at 0)
and the deadlines, where given, lie far beyond the run.
"""
from __future__ import annotations

import ast

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.serve import ReplicaRouter, Status  # noqa: E402
from repro_torch.serve.queue import TERMINAL  # noqa: E402
from torch_parity import jax_params, lm_cfgs  # noqa: E402

BASE = dict(n=10, slots=2, max_len=64, prompt_range=(4, 12),
            gen_range=(2, 8))
ARGV = ["--arch", "qwen2-1.5b-reduced", "--trace", "10", "--slots", "2",
        "--max-len", "64", "--prompt-range", "4,12", "--gen-range", "2,8",
        "--device", "cpu"]
COUNTS = ("requests", "done", "rejected", "expired", "cancelled", "failed",
          "tokens")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    jcfg, _ = lm_cfgs()
    params = jax_params(jcfg, seed=8)
    out = str(tmp_path_factory.mktemp("ckpt"))
    jax_save(out, 0, params, extra={"config": jcfg.name})
    return {"dir": out, "jm": jax_build(jcfg),
            "jp": jax.tree.map(jnp.asarray, params)}


def _prefix_logs(lines):
    """The prefix-cache stats dicts of the JAX CLI's log lines."""
    return [ast.literal_eval(ln.split("cache: ", 1)[1]) for ln in lines
            if "prefix cache: " in ln]


def _both(ckpt, argv, **kw):
    lines = []
    handles, table = jax_serve.serve_trace(ckpt["jm"], ckpt["jp"],
                                           log=lines.append, **BASE, **kw)
    res = pt_serve.main(ARGV + ["--ckpt-in", ckpt["dir"]] + argv)
    got = [(h.rid, h.status.value, list(h.tokens)) for h in res["handles"]]
    want = [(h.rid, h.status.value, [int(t) for t in h.tokens])
            for h in handles]
    assert got == want
    for key in COUNTS:
        assert res["table"][key] == table[key], key
    assert sum(res["table"][k] for k in COUNTS[1:6]) == BASE["n"]
    assert all(h.status in TERMINAL for h in res["handles"])
    fe = res["frontend"]
    if isinstance(fe.engine, ReplicaRouter):
        stats = fe.engine.prefix_stats() or []
    else:
        stats = [] if fe.prefix_cache is None else [fe.prefix_cache.stats()]
    assert stats == _prefix_logs(lines)
    return res, table


def test_queue_depth_rejects_what_the_queue_cannot_hold(ckpt):
    res, _ = _both(ckpt, ["--queue-depth", "2"], queue_depth=2)
    assert res["table"]["rejected"] == 10 - 2 - 2
    assert res["table"]["mode"] == "frontend"


def test_shortest_prompt_first(ckpt):
    res, _ = _both(ckpt, ["--spf", "--queue-depth", "8"], queue_depth=8,
                   spf=True)
    assert res["table"]["done"] == 10


def test_prefix_cache_over_a_shared_prefix(ckpt):
    res, _ = _both(ckpt, ["--prefix-cache", "3", "--prefix-len", "12"],
                   prefix_cache=3, prefix_len=12)
    pc = res["frontend"].prefix_cache.stats()
    assert pc["hits"] == res["stats"]["prefix_hits"] == 9
    assert pc["reused_tokens"] >= 12 * 9 and pc["evictions"] > 0
    assert res["warmup_stats"]["walk_steps"] == 1


def test_two_replicas_least_loaded(ckpt):
    res, _ = _both(ckpt, ["--replicas", "2"], replicas=2)
    assert res["table"]["mode"] == "fleet-x2"
    router = res["frontend"].engine
    assert router.rstats["routed_admits"] == 10
    assert all(r.engine.stats["admits"] == 5 for r in router.replicas)


def test_two_replicas_prefix_affinity(ckpt):
    res, _ = _both(ckpt, ["--replicas", "2", "--route", "prefix-affinity",
                          "--prefix-cache", "2", "--prefix-len", "12"],
                   replicas=2, route="prefix-affinity", prefix_cache=2,
                   prefix_len=12)
    router = res["frontend"].engine
    assert router.rstats["affinity_hits"] > 0
    assert res["stats"]["prefix_hits"] == router.rstats["affinity_hits"]


def test_deadline_flags_parse_and_each_request_ends_once(ckpt):
    """Deadlines of 600-900 s on half the requests (none passes in the
    run), chunked prefill and the prefix cache together."""
    res, _ = _both(ckpt, ["--deadline-ms", "600000,900000",
                          "--deadline-frac", "0.5", "--prefix-cache", "2",
                          "--prefix-len", "8", "--prefill-chunk", "4"],
                   deadline_ms=(600000.0, 900000.0), deadline_frac=0.5,
                   prefix_cache=2, prefix_len=8, prefill_chunk=4)
    hs = res["handles"]
    with_deadline = [h for h in hs if h.deadline is not None]
    assert 0 < len(with_deadline) < len(hs)
    assert all(600 <= h.deadline - h.req.arrival <= 901
               for h in with_deadline)
    assert [h.status for h in hs] == [Status.DONE] * len(hs)


def test_mesh_flags_still_raise_by_name():
    """Beside --serve-sharded, the flags a sharded engine does not take
    raise by name (ROADMAP Queue 1 item 2b-ii)."""
    for flag in (["--prefix-cache", "2"], ["--replicas", "2"]):
        with pytest.raises(NotImplementedError, match=flag[0]):
            pt_serve.main(ARGV + ["--serve-sharded", "--mesh-shape", "1x2",
                                  "--dist-backend", "gloo"] + flag)
