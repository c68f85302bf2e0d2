"""The port's plain wkv6 (``repro_torch.kernels.wkv6``) against the JAX
package's RWKV-6 recurrence.

Inputs are made with numpy from a seed and go to both packages. The JAX
side runs its exact scan (``ref``) and its Pallas kernel in interpret mode
at the chunk sizes of tests/test_kernels.py. Two fp32 exact scans differ
only in the order of their sums: rtol/atol 1e-5. Against the chunked
Pallas kernel the bound is the JAX package's own kernel-vs-ref bound,
rtol/atol 1e-3 (tests/test_kernels.py:193-198). On CPU tensors the ``ops``
wrapper takes the plain scan and launches nothing.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.wkv6 import ops as jax_ops  # noqa: E402
from repro.kernels.wkv6 import ref as jax_ref  # noqa: E402
from repro_torch.kernels.wkv6 import ops, ref  # noqa: E402

EXACT = 1e-5
CHUNKED = 1e-3
# (t, h, n, chunk) of tests/test_kernels.py::test_wkv6_vs_ref
CASES = [(64, 2, 16, 16), (128, 1, 32, 32), (256, 4, 8, 64)]


def _inputs(B, T, H, N, seed, state=False):
    """r, k, v standard normal; w in (0.35, 0.95) as the JAX test draws it;
    u small; an optional initial state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    w = (0.35 + 0.6 / (1 + np.exp(-rng.standard_normal((B, T, H, N))))) \
        .astype(np.float32)
    u = (0.1 * rng.standard_normal((H, N))).astype(np.float32)
    out = [r, k, v, w, u]
    if state:
        out.append(rng.standard_normal((B, H, N, N)).astype(np.float32))
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("t,h,n,chunk", CASES)
def test_wkv6_ref_matches_jax_ref(t, h, n, chunk):
    args = _inputs(2, t, h, n, seed=t + h)
    wy, ws = jax_ref.wkv6(*map(jnp.asarray, args))
    gy, gs = ref.wkv6(*_port(*args))
    assert gy.dtype == gs.dtype == torch.float32
    _close(gy, wy, EXACT)
    _close(gs, ws, EXACT)


@pytest.mark.parametrize("t,h,n,chunk", CASES)
def test_wkv6_ref_matches_pallas_interpret(t, h, n, chunk):
    args = _inputs(2, t, h, n, seed=t * h)
    wy, ws = jax_ops.wkv6(*map(jnp.asarray, args), impl="interpret",
                          chunk=chunk)
    gy, gs = ref.wkv6(*_port(*args))
    _close(gy, wy, CHUNKED)
    _close(gs, ws, CHUNKED)


@pytest.mark.parametrize("T,split", [(64, 32), (100, 37), (9, 1)])
def test_wkv6_state_continuation(T, split):
    """Two halves with the state carried (in place through ``ops``) equal
    one pass over the whole; the halves need not be chunk multiples."""
    r, k, v, w, u = _port(*_inputs(2, T, 3, 16, seed=T))
    y_full, s_full = ref.wkv6(r, k, v, w, u)
    before = ops.launches
    y1, s1 = ops.wkv6(r[:, :split], k[:, :split], v[:, :split],
                      w[:, :split], u)
    y2, s2 = ops.wkv6(r[:, split:], k[:, split:], v[:, split:],
                      w[:, split:], u, s1, out_state=s1)
    assert s2 is s1 and ops.launches == before
    _close(torch.cat([y1, y2], dim=1), y_full, 1e-4)
    _close(s2, s_full, 1e-4)


def test_wkv6_one_token_with_a_state_matches_jax():
    """The decode case: T = 1 from a given state, updated in place."""
    r, k, v, w, u, s0 = _inputs(3, 1, 4, 16, seed=5, state=True)
    wy, ws = jax_ref.wkv6(*map(jnp.asarray, (r, k, v, w, u)),
                          state=jnp.asarray(s0))
    state = torch.from_numpy(s0.copy())
    gy, gs = ops.wkv6(*_port(r, k, v, w, u), state, out_state=state)
    assert gs is state
    _close(gy, wy, EXACT)
    _close(state, ws, EXACT)
    # y_0 = r (S0 + (u * k) v^T), S' = diag(w) S0 + k v^T, written out
    kv = k[0, 0, :, :, None] * v[0, 0, :, None, :]
    want_y = np.einsum("hn,hnm->hm", r[0, 0], s0[0] + u[:, :, None] * kv)
    _close(gy[0, 0], want_y, EXACT)
    _close(state[0], w[0, 0][:, :, None] * s0[0] + kv, EXACT)


def test_wkv6_bf16_inputs_match_jax_ref():
    """bf16 r, k, v, w: the scan runs in fp32 and y comes back in bf16."""
    args = _inputs(1, 40, 2, 16, seed=9)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in args[:4]]
    gy, gs = ops.wkv6(*bf, torch.from_numpy(args[4]))
    wy, ws = jax_ref.wkv6(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                            for t in bf), jnp.asarray(args[4]))
    assert gy.dtype == torch.bfloat16 and gs.dtype == torch.float32
    _close(gy.float(), np.asarray(wy, np.float32), 2e-2)
    _close(gs, ws, EXACT)
