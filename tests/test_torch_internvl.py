"""The port's VLM stub frontend (internvl2-26b) against the JAX package:
precomputed patch embeddings put before the token embeddings in the
forward and the prefill, the ``patch_stub`` calibration stream, CORP over
it, and serving the backbone.

internvl2-26b-reduced in fp32 on the CPU (2 layers, d 64, GQA 4/1 of 16,
GLU d_ff 256, rope theta 1e6), on the same numpy-made weights
(``torch_parity.jax_params``) and the reference's calibration stream
(Markov tokens plus 8 patch embeddings a sequence). Values are held to
rtol 1e-4, atol 1e-5 (as ``tests/test_torch_gemma.py``); streams and
integer leaves must be equal; pruned models are compared through their
logits on held-out batches (relative error <= 1e-3 against JAX).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.core import PruneConfig as JaxPC  # noqa: E402
from repro.core import corp_prune as jax_corp_prune  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro.serve import synthetic_trace as jax_trace  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import PruneConfig, corp_prune  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from torch_parity import lm_logits, lm_prune_setup, rel  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
ARCH = "internvl2-26b"
P = 8                     # patches a sequence, as the calibration stream
MAX_LEN = 48


@pytest.fixture(scope="module")
def s():
    s = lm_prune_setup(ARCH, seed=12)
    patches = np.random.default_rng(12).standard_normal(
        (3, P, s["cfg"].d_model)).astype(np.float32)
    s["jax_held"]["patch_embeds"] = jnp.asarray(patches)
    s["pt_held"]["patch_embeds"] = torch.from_numpy(patches)
    return s


def _batch(cfg, T, B=2, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    pe = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(pe)},
            {"tokens": torch.from_numpy(toks),
             "patch_embeds": torch.from_numpy(pe)})


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)


def test_config_is_a_dense_gqa_backbone_with_the_patch_stub(s):
    cfg = s["cfg"]
    assert cfg.frontend == "patch_stub" and cfg.moe is None
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.rope_theta) == (4, 1, 1e6)
    assert cfg.layout() == s["jcfg"].layout() == [("scan", 2, [0])]


def test_apply_lm_with_patches_matches_jax(s):
    """Logits over the P + T positions (the patches first), and the taps,
    stacked over the layers, of the combined sequence."""
    jb, pb = _batch(s["cfg"], 12)
    jt, pt = {}, {}
    want, _ = s["jax_model"].apply(s["jax_params"], jb, taps=jt)
    got, _ = s["pt_model"].apply(s["pt_params"], pb, taps=pt)
    assert got.shape == (2, P + 12, s["cfg"].padded_vocab)
    _close(got.numpy(), np.asarray(want))
    assert sorted(pt) == sorted(jt)
    assert pt["seg0/p0/h"].shape == (2, 2, P + 12, 256)
    for k in jt:
        _close(pt[k].numpy(), np.asarray(jt[k]), k)


def test_prefill_with_patches_then_decode_matches_jax(s):
    """The prefill's cache holds P + T positions (``pos`` P + T), then 3
    decode steps: every step's logits and the final cache equal JAX's."""
    jb, pb = _batch(s["cfg"], 10, seed=1)
    jl, jc = s["jax_model"].prefill(s["jax_params"], jb, MAX_LEN)
    pl, pc = s["pt_model"].prefill(s["pt_params"], pb, MAX_LEN)
    assert pc["pos"].tolist() == [P + 10] * 2
    _close(pl.numpy(), np.asarray(jl))
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1, :s["cfg"].vocab_size], -1),
                         np.int32)[:, None]
        jl, jc = s["jax_model"].decode_step(s["jax_params"],
                                            jnp.asarray(nxt), jc)
        pl, pc = s["pt_model"].decode_step(s["pt_params"],
                                           torch.from_numpy(nxt.copy()), pc)
        _close(pl.numpy(), np.asarray(jl), f"step {step}")
    g = interop.flatten(interop.to_numpy(pc))
    w = interop.flatten(jax.tree.map(np.asarray, jc))
    assert list(g) == list(w)
    for k in w:
        if w[k].dtype.kind == "i":
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            _close(g[k], w[k], k)


def test_ragged_prefill_with_patches_is_a_reference_fault_the_port_refuses(
        s):
    """JAX's ``lm_prefill(lengths=, patch_embeds=)`` gathers the logits at
    ``lengths - 1`` of the combined sequence: with 6 and 4 true tokens
    after 8 patches those are patch rows 5 and 3, not the last tokens' rows
    13 and 11 (``repro/models/lm.py`` ``lm_prefill``). The port raises."""
    jb, pb = _batch(s["cfg"], 6, seed=2)
    lengths = np.array([6, 4], np.int32)
    jl, jc = s["jax_model"].prefill(s["jax_params"], jb, MAX_LEN,
                                    lengths=jnp.asarray(lengths))
    full, _ = s["jax_model"].apply(s["jax_params"], jb)
    full = np.asarray(full)
    rows = np.arange(2)
    np.testing.assert_allclose(np.asarray(jl)[:, 0], full[rows, lengths - 1],
                               rtol=RTOL, atol=ATOL)
    assert np.abs(np.asarray(jl)[:, 0] - full[rows, P + lengths - 1]) \
        .max() > 1e-2
    assert np.asarray(jc["pos"]).tolist() == [6, 4]
    with pytest.raises(ValueError, match="patch_embeds"):
        s["pt_model"].prefill(s["pt_params"], pb, MAX_LEN,
                              lengths=torch.from_numpy(lengths))


def test_patch_stub_stream_is_identical_to_jax(s):
    """Tokens and patch embeddings (float32, drawn after the tokens from
    ``RandomState(seed + i)``) byte for byte."""
    a, b = list(s["pt_calib"]()), list(s["jax_calib"]())
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y) == ["patch_embeds", "tokens"]
        assert x["patch_embeds"].dtype == torch.float32
        assert x["patch_embeds"].shape == (8, P, 64)
        for k in x:
            np.testing.assert_array_equal(x[k].numpy(), np.asarray(y[k]))


@pytest.mark.parametrize("one_traversal", [False, True])
def test_corp_prune_with_patches_matches_jax(s, one_traversal):
    """0.5/0.5 (GLU MLP, class-2 rope attention) calibrated on the
    patch-stub stream, two passes or one traversal (margin 1.0, a hit):
    held-out logits (with patches) against JAX's ``corp_prune``."""
    kw = dict(one_traversal=one_traversal, spec_margin=1.0)
    jp, jcfg, jrep = jax_corp_prune(s["jax_model"], s["jax_params"],
                                    s["jax_calib"], JaxPC(0.5, 0.5), **kw)
    pp, pcfg, rep = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"],
                               PruneConfig(0.5, 0.5), **kw)
    assert rep["traversals"] == jrep["traversals"] \
        == (1 if one_traversal else 2)
    assert (pcfg.eff_d_ff, pcfg.eff_qk) == (128, 8)
    want = lm_logits(jax_build(jcfg), jp, s["jax_held"])
    with torch.no_grad():
        got = lm_logits(pt_build(pcfg), pp, s["pt_held"])
    assert got.shape == (3, P + 20, pcfg.padded_vocab)
    assert rel(got, want) <= 1e-3


def test_serve_cli_streams_equal_the_jax_engine(s, tmp_path):
    """``launch.serve --arch internvl2-26b-reduced --ckpt-in`` of the JAX
    weights: the backbone serves token prompts (no engine path sends patch
    embeddings), and its streams equal the JAX engine's."""
    jax_save(str(tmp_path), 0, jax.tree.map(np.asarray, s["jax_params"]))
    served = pt_serve.main(
        ["--arch", ARCH + "-reduced", "--ckpt-in", str(tmp_path),
         "--device", "cpu", "--trace", "5", "--slots", "2", "--max-len",
         "40", "--prompt-range", "4,18", "--gen-range", "2,9"])
    jeng = JaxServe(s["jax_model"], s["jax_params"], n_slots=2, max_len=40)
    want = jeng.run(jax_trace(5, s["jcfg"].vocab_size, seed=0,
                              prompt_range=(4, 18), gen_range=(2, 9)))
    assert [c.tokens.tolist() for c in served["completions"]] == \
        [c.tokens.tolist() for c in want]
