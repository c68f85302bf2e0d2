"""The port's LM forward, ragged prefill and decode against the JAX package.

qwen2-1.5b-reduced in fp32 on the CPU, on the same numpy-made weights
(``torch_parity.jax_params`` carried across by ``interop.from_numpy``); the
init, logit and prefill/decode checks also run on granite-8b-reduced and
deepseek-7b-reduced (dense global-attention GLU LMs without the qkv bias,
MHA in deepseek's case, untied embeddings in deepseek's).
Matmuls sum in different orders, so logits and cache leaves are held to
rtol 1e-4, atol 1e-5; integer leaves (``pos``) must be equal. The pruned
config (qk 16 -> 8, dv 16) runs the JAX decode twice: on its jnp path and
with ``REPRO_DECODE_IMPL=interpret``, so the Pallas kernel itself is the
reference.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.common import rope_freqs as jax_rope_freqs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from repro_torch.models.attention import _scatter_time  # noqa: E402
from torch_parity import jax_params, lm_cfgs  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
MAX_LEN = 32
ARCHS = ("qwen2-1.5b", "granite-8b", "deepseek-7b")
LENGTHS = np.array([9, 13], np.int32)


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, int(LENGTHS.max()))).astype(np.int32)


_SETUPS = {}


def _setup(pruned, arch="qwen2-1.5b"):
    """(JAX model, JAX params, port model, port params), made once per
    module for each config."""
    if (pruned, arch) not in _SETUPS:
        jcfg, pcfg = lm_cfgs(pruned, arch=arch)
        params = jax_params(jcfg, seed=3 if pruned else 0)
        _SETUPS[pruned, arch] = (jax_build(jcfg),
                                 jax.tree.map(jnp.asarray, params),
                                 pt_build(pcfg),
                                 interop.from_numpy(params, device="cpu"))
    return _SETUPS[pruned, arch]


def _close_tree(got, want):
    g = interop.flatten(interop.to_numpy(got))
    w = interop.flatten(jax.tree.map(np.asarray, want))
    assert list(g) == list(w)
    for k in w:
        assert (g[k].shape, g[k].dtype) == (w[k].shape, w[k].dtype), k
        if w[k].dtype.kind == "i":
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pruned", [False, True])
def test_init_tree_has_the_jax_key_paths(pruned, arch):
    """The JAX package's key paths, shapes and dtypes; a pruned template
    adds one leaf, ``mlp/bd`` of zeros, the slot for the compensation bias
    CORP pruning writes (JAX's template has none and drops the bias)."""
    _, jp, pm, _ = _setup(pruned, arch)
    want = interop.flatten(jax.tree.map(np.asarray, jp))
    got = interop.flatten(interop.to_numpy(
        pm.init(torch.Generator().manual_seed(0), "cpu")))
    if pruned:
        bd = got.pop("seg0/p0/mlp/bd")
        assert bd.shape == (pm.cfg.n_layers, pm.cfg.d_model) \
            and bd.dtype == np.float32 and not bd.any()
    assert list(got) == list(want)
    assert "seg0/p0/mixer/rope_inv_q" in got
    for k in want:
        assert (got[k].shape, got[k].dtype) == (want[k].shape, want[k].dtype)
    # the rope tables are the JAX package's fp32 frequencies, one row per
    # head (jax_params perturbs every leaf, so rebuild them here)
    cfg = pm.cfg
    inv = jax_rope_freqs(cfg.eff_qk, cfg.rope_theta).astype(np.float32)
    np.testing.assert_array_equal(got["seg0/p0/mixer/rope_inv_k"],
                                  np.tile(inv, (cfg.n_layers,
                                                cfg.n_kv_heads, 1)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pruned", [False, True])
def test_apply_lm_logits_match_jax(pruned, arch):
    jm, jp, pm, pp = _setup(pruned, arch)
    toks = _tokens(pm.cfg)
    want, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    got, aux = pm.apply(pp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, toks.shape[1], pm.cfg.padded_vocab) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pruned,impl", [(False, None), (True, None),
                                         (True, "interpret")])
def test_ragged_prefill_and_decode_match_jax(pruned, impl, arch,
                                             monkeypatch):
    if impl:
        monkeypatch.setenv("REPRO_DECODE_IMPL", impl)
    jm, jp, pm, pp = _setup(pruned, arch)
    V = pm.cfg.vocab_size
    toks = _tokens(pm.cfg, seed=1)
    # jitted after the env is set: the decode traces with that impl
    prefill = jax.jit(lambda p, t, n: jm.prefill(p, {"tokens": t}, MAX_LEN,
                                                 lengths=n))
    decode = jax.jit(jm.decode_step)
    wl, wc = prefill(jp, jnp.asarray(toks), jnp.asarray(LENGTHS))
    gl, gc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, MAX_LEN,
                        lengths=torch.from_numpy(LENGTHS))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=RTOL,
                               atol=ATOL)
    _close_tree(gc, wc)
    assert gc["seg0"]["p0"]["k"].shape[-1] == pm.cfg.eff_qk
    tok = np.asarray(jnp.argmax(wl[:, -1, :V], -1))[:, None].astype(np.int32)
    for step in range(8):
        wl, wc = decode(jp, jnp.asarray(tok), wc)
        gl, gc = pm.decode_step(pp, torch.from_numpy(tok), gc)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {step}")
        tok = np.asarray(jnp.argmax(wl[:, -1, :V], -1))[:, None] \
            .astype(np.int32)
    _close_tree(gc, wc)
    np.testing.assert_array_equal(gc["pos"].numpy(), LENGTHS + 8)


def test_decode_updates_the_cache_in_place():
    _, _, pm, pp = _setup(False)
    _, cache = pm.prefill(pp, {"tokens": torch.from_numpy(_tokens(pm.cfg))},
                          MAX_LEN, lengths=torch.from_numpy(LENGTHS))
    k = cache["seg0"]["p0"]["k"]
    ptr, before = k.data_ptr(), k.clone()
    _, out = pm.decode_step(pp, torch.zeros((2, 1), dtype=torch.int32),
                            cache)
    assert out is cache and out["seg0"]["p0"]["k"].data_ptr() == ptr
    changed = (k != before).any(dim=(0, 3, 4))        # (B, S) rows written
    assert changed.nonzero().tolist() == [[0, 9], [1, 13]]


def test_scatter_time_drops_rows_past_the_end():
    """Free slots keep decoding past max_len: their writes are dropped, as
    JAX drops an out-of-bounds scatter, and nothing raises."""
    buf = torch.zeros(3, 4, 2)
    val = torch.arange(1, 7, dtype=torch.float32).reshape(3, 2)
    _scatter_time(buf, val, torch.tensor([1, 4, 9], dtype=torch.int32))
    want = torch.zeros(3, 4, 2)
    want[0, 1] = val[0]
    torch.testing.assert_close(buf, want, rtol=0, atol=0)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A bf16 checkpoint written by the JAX package (raw uint16 leaves plus
    the dtype in the manifest) loads into the port leaf for leaf; a corrupt
    later step is skipped."""
    jcfg, pcfg = lm_cfgs()
    jcfg, pcfg = jcfg.replace(dtype="bfloat16"), pcfg.replace(
        dtype="bfloat16")
    params = jax.jit(jax_build(jcfg).init)(jax.random.PRNGKey(4))
    jax_save(str(tmp_path), 3, params, extra={"config": jcfg.name})
    bad = tmp_path / "step_00000005"
    bad.mkdir()
    (bad / "manifest.json").write_text('{"sha256": "0"}')
    (bad / "arrays.npz").write_bytes(b"not a checkpoint")
    assert latest_step(str(tmp_path)) == 3
    like = pt_build(pcfg).init(torch.Generator().manual_seed(0), "cpu")
    got, extra = restore_checkpoint(str(tmp_path), 3, like)
    assert extra == {"config": jcfg.name}
    want = interop.flatten(params)
    flat = interop.flatten(got)
    assert list(flat) == sorted(want)
    for k, t in flat.items():
        assert t.dtype == interop.flatten(like)[k].dtype, k
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(want[k]).astype(np.float32),
            err_msg=k)
    assert flat["embed"].dtype == torch.bfloat16
