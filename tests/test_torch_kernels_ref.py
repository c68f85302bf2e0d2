"""The port's plain kernel versions against the JAX Pallas kernels.

The JAX side runs the Pallas kernels in interpret mode on the CPU (as
tests/test_kernels.py does); the port's ``ref.py`` versions get the same
numpy inputs. On CPU tensors the ``ops`` wrappers must return the plain
result and launch nothing.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import ops as jax_flash  # noqa: E402
from repro.kernels.flash_decode import ops as jax_decode  # noqa: E402
from repro.kernels.flash_decode import ref as jax_decode_ref  # noqa: E402
from repro.kernels.gram import ops as jax_gram  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ref as decode_ref  # noqa: E402
from repro_torch.kernels.gram import ops as gram_ops  # noqa: E402
from repro_torch.kernels.gram import ref as gram_ref  # noqa: E402

# fp32 sums in another order than the Pallas interpreter: entries are held
# to rtol 1e-5, with an absolute floor of 1e-5 * max|s2| for entries that
# cancel towards 0
RTOL = 1e-5


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * float(np.abs(b).max()))


@pytest.mark.parametrize("n,f", [(197 * 2, 192), (1000, 40), (37, 5)])
def test_gram_ref_matches_pallas(n, f):
    x = np.random.default_rng(n + f).standard_normal((n, f)) \
        .astype(np.float32)
    want = jax_gram.gram(jnp.asarray(x), impl="interpret")
    got = gram_ref.gram(torch.from_numpy(x))
    assert got["s2"].dtype == torch.float32
    _close(got["s2"], want["s2"])
    _close(got["s1"], want["s1"])


@pytest.mark.parametrize("n,fx,fy", [(300, 24, 40), (129, 70, 3)])
def test_gram_cross_ref_matches_pallas(n, fx, fy):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, fx)).astype(np.float32)
    y = rng.standard_normal((n, fy)).astype(np.float32)
    want = jax_gram.gram_cross(jnp.asarray(x), jnp.asarray(y),
                               impl="interpret")
    got = gram_ref.gram_cross(torch.from_numpy(x), torch.from_numpy(y))
    _close(got["s2"], want["s2"])
    _close(got["s1"], want["s1"])


def test_gram_layer_stack_is_per_layer_gram():
    """The layer-stacked (L, N, F) call equals one gram per layer."""
    x = np.random.default_rng(0).standard_normal((3, 50, 12)) \
        .astype(np.float32)
    got = gram_ops.gram(torch.from_numpy(x))
    for i in range(3):
        want = jax_gram.gram(jnp.asarray(x[i]), impl="interpret")
        _close(got["s2"][i], want["s2"])
        _close(got["s1"][i], want["s1"])


# name: (B, T, S, H, Hkv, dq, dv, causal, window)
ATTN_CASES = {
    "full": (2, 37, 37, 4, 4, 16, 16, False, None),
    "causal": (1, 64, 64, 2, 2, 16, 16, True, None),
    "window": (1, 64, 64, 2, 2, 16, 16, True, 8),
    "gqa": (2, 32, 32, 4, 2, 8, 8, True, None),
    "dq_ne_dv": (1, 40, 40, 2, 2, 8, 24, False, None),
    "t_lt_s": (1, 16, 48, 2, 1, 16, 16, True, None),
}


def _qkv(case):
    B, T, S, H, Hkv, dq, dv, _, _ = case
    rng = np.random.default_rng(T * S + dq)
    return (rng.standard_normal((B, T, H, dq)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, dq)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, dv)).astype(np.float32))


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_attention_ref_matches_pallas(name):
    case = ATTN_CASES[name]
    causal, window = case[-2], case[-1]
    q, k, v = _qkv(case)
    scale = 0.3
    want = jax_flash.attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               scale=scale, impl="interpret")
    got = flash_ref.attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window, scale=scale)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# name: (B, S, H, Hkv, dq, dv, bs); bs is the Pallas kernel's split size
# (it needs S % bs == 0); "ragged" S is not a multiple of the CUDA
# kernel's 64-key tile
DECODE_CASES = {
    "gqa_12_2": (2, 128, 12, 2, 32, 32, 32),
    "gqa_4_1": (2, 96, 4, 1, 16, 16, 32),
    "mha": (2, 64, 4, 4, 16, 16, 16),
    "dq_ne_dv": (2, 64, 4, 2, 8, 16, 16),
    "ragged_s": (2, 100, 4, 2, 16, 16, 50),
}


def _decode_inputs(case, dtype=np.float32):
    """q, k, v and a valid mask: row 0 has holes, row 1 a whole invalid
    split in the middle and an invalid tail longer than a split."""
    B, S, H, Hkv, dq, dv, bs = case
    rng = np.random.default_rng(S * H + dq)
    q = rng.standard_normal((B, H, dq)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, dq)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, dv)).astype(np.float32)
    valid = np.ones((B, S), bool)
    valid[0] = rng.random(S) < 0.7
    valid[0, 0] = True
    valid[1, bs:2 * bs] = False
    valid[1, S - bs - 3:] = False
    if dtype != np.float32:
        q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    return q, k, v, valid


def _to_torch(a):
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))) \
            .to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype,tol", [(np.float32, RTOL),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_ref_matches_pallas(name, dtype, tol):
    """The port's plain decode attention (and its wrapper on CPU tensors)
    against the JAX ref and the interpret-mode Pallas kernel with its
    logsumexp merge."""
    case = DECODE_CASES[name]
    q, k, v, valid = _decode_inputs(case, dtype)
    scale = 0.25
    args = [jnp.asarray(a) for a in (q, k, v, valid)]
    want_ref = jax_decode_ref.decode_attention(*args, scale)
    want_pal = jax_decode.decode_attention(*args, scale=scale, bs=case[-1],
                                           impl="interpret")
    tq, tk, tv = (_to_torch(a) for a in (q, k, v))
    tvalid = torch.from_numpy(valid)
    got = decode_ref.decode_attention(tq, tk, tv, tvalid, scale)
    assert got.dtype == tq.dtype and tuple(got.shape) == want_ref.shape
    got_ops = decode_ops.decode_attention(tq, tk, tv, tvalid.to(torch.int8),
                                          scale=scale)
    torch.testing.assert_close(got_ops, got, rtol=0, atol=0)
    for want in (want_ref, want_pal):
        _close(got.float(), np.asarray(jnp.asarray(want, jnp.float32)),
               rtol=tol)


@pytest.mark.parametrize("name", ["gqa_12_2", "dq_ne_dv"])
def test_decode_row_with_no_valid_key_gives_zero(name):
    """Row 1 loses every key: it is 0, as the Pallas kernel (and the CUDA
    kernel) give, where the JAX ref gives the mean of V; row 0 stays the
    JAX ref's and the Pallas kernel's result."""
    case = DECODE_CASES[name]
    q, k, v, valid = _decode_inputs(case)
    valid[1] = False
    args = [jnp.asarray(a) for a in (q, k, v, valid)]
    want_pal = np.asarray(jax_decode.decode_attention(
        *args, scale=0.25, bs=case[-1], impl="interpret"))
    want_ref = np.asarray(jax_decode_ref.decode_attention(*args, 0.25))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = decode_ops.decode_attention(tq, tk, tv, torch.from_numpy(valid),
                                      scale=0.25).numpy()
    assert np.array_equal(got[1], np.zeros_like(got[1]))
    assert np.array_equal(want_pal[1], np.zeros_like(want_pal[1]))
    assert np.abs(want_ref[1]).max() > 0
    for want in (want_ref, want_pal):
        _close(got[0], want[0])


def test_ops_take_plain_version_on_cpu_and_launch_nothing():
    before = (gram_ops.launches, flash_ops.launches, decode_ops.launches)
    x = torch.randn(20, 6)
    g = gram_ops.gram(x)
    torch.testing.assert_close(g["s2"], x.T @ x)
    q, k, v = (torch.from_numpy(a) for a in _qkv(ATTN_CASES["gqa"]))
    o = flash_ops.attention(q, k, v, causal=True)
    torch.testing.assert_close(o, flash_ref.attention(q, k, v, causal=True))
    q, k, v, valid = (torch.from_numpy(a) for a in
                      _decode_inputs(DECODE_CASES["mha"]))
    torch.testing.assert_close(decode_ops.decode_attention(q, k, v, valid),
                               decode_ref.decode_attention(q, k, v, valid,
                                                           0.25))
    assert (gram_ops.launches, flash_ops.launches,
            decode_ops.launches) == before


def test_ops_refuse_a_device_without_a_kernel():
    """A tensor on neither the CPU nor CUDA never reaches a plain path."""
    x = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError):
        gram_ops.gram(x)
    q = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError):
        flash_ops.attention(q, q, q)
    k = torch.empty(1, 16, 2, 8, device="meta")
    with pytest.raises(ValueError):
        decode_ops.decode_attention(q[:, 0], k, k,
                                    torch.ones(1, 16, dtype=torch.bool))
