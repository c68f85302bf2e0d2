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
from repro.kernels.gram import ops as jax_gram  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
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


def test_ops_take_plain_version_on_cpu_and_launch_nothing():
    before = (gram_ops.launches, flash_ops.launches)
    x = torch.randn(20, 6)
    g = gram_ops.gram(x)
    torch.testing.assert_close(g["s2"], x.T @ x)
    q, k, v = (torch.from_numpy(a) for a in _qkv(ATTN_CASES["gqa"]))
    o = flash_ops.attention(q, k, v, causal=True)
    torch.testing.assert_close(o, flash_ref.attention(q, k, v, causal=True))
    assert (gram_ops.launches, flash_ops.launches) == before


def test_ops_refuse_a_device_without_a_kernel():
    """A tensor on neither the CPU nor CUDA never reaches a plain path."""
    x = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError):
        gram_ops.gram(x)
    q = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError):
        flash_ops.attention(q, q, q)
