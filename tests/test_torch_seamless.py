"""The port's seamless-m4t-large-v2 (the encoder-decoder) against the JAX
package: weights carried across, the encoder, the forward with every tap
(``cross_q``/``cross_k`` too), prefill and decode from the enc-dec cache,
cross attention alone at T != S, the trace's frames and the serve engine
under the ``encdec`` slot-cache contract.

seamless-m4t-large-v2-reduced in fp32 on the CPU (2 encoder and 2
decoder layers, d 64, 4/4 heads of 16), the same numpy-made weights in
both packages; JAX runs single-device, its attention through its own CPU
path. Values are held to rtol 1e-5 and atol 1e-5 of each array's scale
(its largest magnitude, at least 1); token streams must be equal.
"""
from __future__ import annotations

import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import synthetic_trace as jax_trace  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import attention as pt_attn  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from repro_torch.models import encdec as pt_encdec  # noqa: E402
from repro_torch.serve import (Request, ServeEngine, errors,  # noqa: E402
                               synthetic_trace)
from torch_parity import jax_params, lm_cfgs  # noqa: E402

ARCH = "seamless-m4t-large-v2"
RTOL, ATOL = 1e-5, 1e-5
MEM, SLOTS, MAX_LEN = 10, 2, 24
# (prompt, gen) of the engine trace: retire and refill over 2 slots
SPECS = [(5, 4), (9, 6), (3, 2)]


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=err_msg)


@pytest.fixture(scope="module")
def m():
    jcfg, pcfg = lm_cfgs(arch=ARCH)
    params = jax_params(jcfg, seed=3)
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    return {"jcfg": jcfg, "cfg": pcfg, "np": params,
            "jmodel": jax_build(jcfg),
            "jparams": jax.tree.map(jnp.asarray, params),
            "model": pt_build(pcfg),
            "params": interop.from_numpy(params, device="cpu"),
            "frames": frames, "tokens": tokens}


def _jbatch(m, frames=None, tokens=None):
    return {"frames": jnp.asarray(m["frames"] if frames is None else frames),
            "tokens": jnp.asarray(m["tokens"] if tokens is None
                                  else tokens)}


def _pbatch(m, frames=None, tokens=None):
    return {"frames": torch.from_numpy(m["frames"] if frames is None
                                       else frames),
            "tokens": torch.from_numpy(m["tokens"] if tokens is None
                                       else tokens)}


def test_config_and_weights_carry_over(m):
    """The reduced config is JAX's field for field (2 + 2 layers, class-1
    attention everywhere: family encdec, no rope); the port's params have
    JAX's key paths and shapes, the decoder with ``ln_cross``/``cross``,
    and the leaves cross by ``interop`` bit for bit."""
    cfg = m["cfg"]
    assert (cfg.n_enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_head) == (2, 2, 64, 4, 4, 16)
    want = interop.flatten(m["np"])
    own = interop.flatten(m["model"].init(torch.Generator().manual_seed(0),
                                          device="cpu"))
    assert {k: tuple(v.shape) for k, v in own.items()} \
        == {k: v.shape for k, v in want.items()}
    assert {"dec/p0/cross/wq", "dec/p0/ln_cross/scale", "enc/p0/mixer/wk",
            "enc_final_norm/bias"} <= set(own)
    assert not any(k.startswith("enc/p0/cross") for k in own)
    assert "rope_inv_q" not in m["params"]["dec"]["p0"]["mixer"]
    for k, v in interop.flatten(m["params"]).items():
        np.testing.assert_array_equal(v.numpy(), want[k], k)


def test_encoder_memory_matches_jax(m):
    want = jax_encdec.encode(m["jparams"], jnp.asarray(m["frames"]),
                             m["jcfg"])
    got = pt_encdec.encode(m["params"], torch.from_numpy(m["frames"]),
                           m["cfg"])
    assert tuple(got.shape) == (2, 12, 64)
    _close(got.numpy(), want)


def test_forward_logits_and_every_tap_match_jax(m):
    """``apply_encdec``'s logits and each tap, stacked by layer: the
    encoder's q, k, h and the decoder's q, k, h with ``cross_q`` (T = 9
    decoder rows) and ``cross_k`` (S = 12 memory rows)."""
    jt, pt = {}, {}
    want, _ = m["jmodel"].apply(m["jparams"], _jbatch(m), taps=jt)
    with torch.no_grad():
        got, _ = m["model"].apply(m["params"], _pbatch(m), taps=pt)
    _close(got.numpy(), want)
    assert sorted(pt) == sorted(jt) == [
        "dec/p0/cross_k", "dec/p0/cross_q", "dec/p0/h", "dec/p0/k",
        "dec/p0/q", "enc/p0/h", "enc/p0/k", "enc/p0/q"]
    assert tuple(pt["dec/p0/cross_q"].shape) == (2, 2, 9, 4, 16)
    assert tuple(pt["dec/p0/cross_k"].shape) == (2, 2, 12, 4, 16)
    for k in jt:
        _close(pt[k].numpy(), jt[k], k)


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_and_four_decode_steps_match_jax(m, ragged):
    """``encdec_prefill`` (ragged: lengths 9 and 5 of right-padded
    prompts) and 4 ``encdec_decode_step``s: the logits of each, and the
    cache's tree, shapes and positions."""
    lengths = np.array([9, 5], np.int32) if ragged else None
    kw = {} if lengths is None else {"lengths": lengths}
    want, jc = m["jmodel"].prefill(
        m["jparams"], _jbatch(m), 16,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got, pc = m["model"].prefill(
        m["params"], _pbatch(m), 16,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(got.numpy(), want, "prefill")
    jflat = interop.flatten(jax.tree.map(np.asarray, jc))
    pflat = interop.flatten(pc)
    assert {k: v.shape for k, v in jflat.items()} \
        == {k: tuple(v.shape) for k, v in pflat.items()}
    assert tuple(pflat["dec/cross/k_mem"].shape) == (2, 2, 12, 4, 16)
    assert tuple(pflat["dec/self/k"].shape) == (2, 2, 16, 4, 16)
    np.testing.assert_array_equal(pflat["pos"].numpy(), jflat["pos"])
    rng = np.random.default_rng(7)
    for step in range(4):
        tok = rng.integers(0, m["cfg"].vocab_size, (2, 1)).astype(np.int32)
        want, jc = m["jmodel"].decode_step(m["jparams"], jnp.asarray(tok),
                                           jc)
        got, pc = m["model"].decode_step(m["params"], torch.from_numpy(tok),
                                         pc)
        _close(got.numpy(), want, f"decode step {step}")
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(pc["dec"]["self"]["pos"].numpy(),
                                  np.asarray(jc["dec"]["self"]["pos"]))


def test_empty_cache_is_the_prefill_tree(m):
    """``init_cache(mem_len=)`` (the engine's slot template) has the
    prefill cache's tree, shapes and dtypes, zeros; without ``mem_len`` it
    refuses."""
    _, pc = m["model"].prefill(m["params"], _pbatch(m), 16)
    tmpl = m["model"].init_cache(2, 16, "cpu", mem_len=12)
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in interop.flatten(pc).items()}
    assert {k: (tuple(v.shape), v.dtype)
            for k, v in interop.flatten(tmpl).items()} == want
    assert not any(v.any() for v in interop.flatten(tmpl).values())
    with pytest.raises(ValueError, match="mem_len"):
        m["model"].init_cache(2, 16, "cpu")


@pytest.mark.parametrize("T,S", [(5, 12), (12, 5)])
def test_cross_attention_alone_at_t_not_s(m, T, S):
    """One decoder block's cross attention, T decoder rows against S
    memory rows (both orders), its taps, and the memory K/V it caches;
    then one decode query against that cache equals the prefill's last
    row."""
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, 64)).astype(np.float32)
    mem = rng.standard_normal((2, S, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], m["jparams"]["dec"]["p0"]["cross"])
    pp = {k: v[0] for k, v in m["params"]["dec"]["p0"]["cross"].items()}
    jt, pt = {}, {}
    want = jax_attn.apply_cross_attn(jp, jnp.asarray(x), jnp.asarray(mem),
                                     m["jcfg"], taps=jt)
    got = pt_attn.apply_cross_attn(pp, torch.from_numpy(x),
                                   torch.from_numpy(mem), m["cfg"], taps=pt)
    _close(got.numpy(), want)
    assert tuple(pt["q"].shape) == (2, T, 4, 16)
    assert tuple(pt["k"].shape) == (2, S, 4, 16)
    for k in jt:
        _close(pt[k].numpy(), jt[k], k)
    jc = jax_attn.precompute_cross_cache(jp, jnp.asarray(mem), m["jcfg"])
    pc = pt_attn.precompute_cross_cache(pp, torch.from_numpy(mem), m["cfg"])
    for k in jc:
        _close(pc[k].numpy(), jc[k], k)
    last = torch.from_numpy(x[:, -1:])
    step = pt_attn.decode_cross_attn(pp, last, pc, m["cfg"])
    _close(step.numpy(), jax_attn.decode_cross_attn(
        jp, jnp.asarray(x[:, -1:]), jc, m["jcfg"]))
    _close(step.numpy(), got[:, -1:].numpy())


def test_synthetic_trace_frames_equal_jax():
    """``synthetic_trace(mem_len=, d_model=)``: the same seed gives the same
    prompts, generation lengths and frames (substream 5) in both
    packages."""
    kw = dict(seed=3, prompt_range=(4, 12), gen_range=(2, 6), mem_len=MEM,
              d_model=64)
    want = jax_trace(5, 503, **kw)
    got = synthetic_trace(5, 503, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.frames, b.frames)
        assert a.gen == b.gen and a.frames.dtype == np.float32
    assert synthetic_trace(2, 503, seed=3)[0].frames is None


@pytest.fixture(scope="module")
def trace(m):
    rng = np.random.RandomState(0)
    specs = [(rng.randint(0, m["cfg"].vocab_size, size=p).astype(np.int32),
              g, rng.randn(MEM, 64).astype(np.float32)) for p, g in SPECS]
    jeng = JaxEngine(m["jmodel"], m["jparams"], n_slots=SLOTS,
                     max_len=MAX_LEN, mem_len=MEM)
    jcomps = jeng.run([JaxRequest(rid=i, tokens=t, gen=g, frames=f)
                       for i, (t, g, f) in enumerate(specs)])
    return {"reqs": [Request(rid=i, tokens=t, gen=g, frames=f)
                     for i, (t, g, f) in enumerate(specs)],
            "streams": [c.tokens.tolist() for c in jcomps],
            "stats": dict(jeng.stats)}


@pytest.mark.parametrize("chunk", [None, 4])
def test_engine_streams_equal_the_jax_engine(m, trace, chunk):
    """``ServeEngine(mem_len=)`` over 3 requests in 2 slots (one refill),
    with and without chunked prefill (the frames go into the first chunk,
    the rest of the prompt walks through batch-1 decode steps): the JAX
    engine's streams; each also a greedy rollout of one full forward."""
    eng = ServeEngine(m["model"], m["params"], n_slots=SLOTS,
                      max_len=MAX_LEN, mem_len=MEM)
    assert eng.contract == "encdec" and eng.ragged_ok
    comps = eng.run(trace["reqs"], prefill_chunk=chunk)
    assert [c.tokens.tolist() for c in comps] == trace["streams"]
    assert [len(c.tokens) for c in comps] == [g for _, g in SPECS]
    if chunk is None:
        for key in ("admits", "refills", "decode_steps", "decode_lanes"):
            assert eng.stats[key] == trace["stats"][key], key
    else:
        assert eng.stats["chunk_steps"] > 0 and eng.stats["walk_steps"] > 0
    for req, c in zip(trace["reqs"], comps):
        seq = np.concatenate([req.tokens, c.tokens[:-1]])[None]
        logits, _ = m["model"].apply(m["params"], {
            "frames": torch.from_numpy(req.frames)[None],
            "tokens": torch.from_numpy(seq)})
        P = len(req.tokens)
        pred = logits[0, P - 1:, : m["cfg"].vocab_size].argmax(-1)
        assert pred.tolist() == c.tokens.tolist(), req.rid


def test_slot_bytes_split_into_self_and_memory(m):
    """A slot holds the decoder's K/V at max_len and the memory K/V at
    mem_len; the memory part grows with mem_len only."""
    parts = {(n, s): ServeEngine(m["model"], m["params"], n_slots=SLOTS,
                                 max_len=n, mem_len=s).slotcache.slot_parts
             for n, s in ((24, 10), (48, 10), (24, 20))}
    per_row = 2 * 2 * 4 * 16 * 4           # layers, k+v, heads, dim, fp32
    assert parts[24, 10]["memory"] == 10 * per_row
    assert parts[24, 20]["memory"] == 20 * per_row
    assert parts[48, 10]["memory"] == 10 * per_row
    assert parts[24, 10]["self"] == 24 * per_row + 2 * 4 + 4
    assert parts[48, 10]["self"] == 48 * per_row + 2 * 4 + 4


def test_engine_refusals_use_the_error_table(m):
    """No ``mem_len``: ``encdec_needs_mem_len`` at construction; frames of
    another length: ``frames_mem_len_mismatch`` at admit (the JAX
    engine's messages)."""
    with pytest.raises(ValueError,
                       match=re.escape(errors.msg("encdec_needs_mem_len"))):
        ServeEngine(m["model"], m["params"], n_slots=SLOTS, max_len=MAX_LEN)
    eng = ServeEngine(m["model"], m["params"], n_slots=SLOTS,
                      max_len=MAX_LEN, mem_len=MEM)
    bad = Request(rid=4, tokens=np.zeros(5, np.int32), gen=2,
                  frames=np.zeros((MEM + 1, 64), np.float32))
    with pytest.raises(ValueError, match=re.escape(errors.msg(
            "frames_mem_len_mismatch", rid=4, frames=MEM + 1,
            mem_len=MEM))):
        eng.admit(bad, 0)
    assert eng.slots[0].free


def test_serve_cli_serves_the_encdec(m):
    """``launch.serve --mem-len``: the trace path (every request carries
    its frames; the stats line splits a slot into self and memory bytes)
    and the fixed-batch loop (frames of ``--prompt-len`` rows)."""
    res = pt_serve.main(["--arch", ARCH + "-reduced", "--trace", "4",
                         "--slots", "2", "--max-len", "40", "--mem-len",
                         "16", "--prompt-range", "4,12", "--gen-range",
                         "2,6", "--device", "cpu"])
    assert len(res["completions"]) == 4
    assert all(len(c.tokens) >= 2 for c in res["completions"])
    out = pt_serve.main(["--arch", ARCH + "-reduced", "--batch", "2",
                         "--prompt-len", "8", "--gen", "3", "--device",
                         "cpu"])
    assert tuple(out["tokens"].shape) == (2, 3)
