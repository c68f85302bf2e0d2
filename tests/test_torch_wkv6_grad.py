"""The gradient of the port's wkv6 (``repro_torch.kernels.wkv6``: the plain
``ref.wkv6_bwd`` and the autograd Function of ``ops.wkv6``) against the
JAX package's, on the CPU.

Inputs are made with numpy from a seed, as in tests/test_torch_wkv6.py,
and go to both packages; the cotangents are (dy, dS_T). JAX's side is
``jax.vjp`` of its exact scan (``ref``), where two fp32 reverse scans
differ only in the order of their sums (rtol/atol 1e-5, the forward's
``EXACT``), and of its chunked jnp path (``ops.wkv6(impl="xla")``, the
log-space form of the Pallas kernel: 1e-3, the forward's ``CHUNKED``).
bf16 inputs: the gradients come back in bf16 (du and the state's in
fp32), within 2e-2. On CPU tensors the wrappers take the plain versions
and launch nothing.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.wkv6 import ops as jax_ops  # noqa: E402
from repro.kernels.wkv6 import ref as jax_ref  # noqa: E402
from repro_torch.kernels.wkv6 import backward, ops, ref  # noqa: E402

EXACT = 1e-5
CHUNKED = 1e-3


def _inputs(B, T, H, N, seed, state=False, w_lo=None):
    """r, k, v standard normal; w in (0.35, 0.95) as tests/test_torch_wkv6.py
    draws it, or uniform in (w_lo, 0.95); u small; cotangents dy and dS_T;
    an optional initial state."""
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((B, T, H, N)).astype(np.float32)
                   for _ in range(4))
    z = rng.standard_normal((B, T, H, N))
    w = (0.35 + 0.6 / (1 + np.exp(-z)) if w_lo is None
         else rng.uniform(w_lo, 0.95, (B, T, H, N))).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, N))).astype(np.float32)
    ds = rng.standard_normal((B, H, N, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32) \
        if state else None
    return (r, k, v, w, u, s0), dy, ds


def _jax_vjp(fn, args, dy, ds):
    """JAX's gradients of ``fn(*args)`` -> (y, S_T) at cotangents (dy,
    ds), as numpy, for every argument (the state's when it is given)."""
    given = [jnp.asarray(a) for a in args if a is not None]
    has_state = args[5] is not None

    def f(*xs):
        return fn(*xs) if has_state else fn(*xs, None)

    _, pull = jax.vjp(f, *given)
    return [np.asarray(g) for g in pull((jnp.asarray(dy), jnp.asarray(ds)))]


def _port(args, dy, ds):
    t = [None if a is None else torch.from_numpy(a) for a in args]
    return ref.wkv6_bwd(*t, torch.from_numpy(dy), torch.from_numpy(ds))


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("T", [1, 9, 64, 100])
def test_wkv6_bwd_matches_jax_vjp_of_the_exact_scan(T, state):
    args, dy, ds = _inputs(2, T, 3, 16, seed=T + 7 * state, state=state)
    want = _jax_vjp(jax_ref.wkv6, args, dy, ds)
    got = _port(args, dy, ds)
    assert got[4].dtype == torch.float32 and got[4].shape == (3, 16)
    assert (got[5] is None) == (not state)
    _close([g for g in got if g is not None], want, EXACT)


@pytest.mark.parametrize("T", [192, 256])
def test_wkv6_bwd_matches_jax_vjp_of_the_chunked_path(T):
    args, dy, ds = _inputs(1, T, 2, 16, seed=T, state=True)

    def chunked(r, k, v, w, u, s):
        return jax_ops.wkv6(r, k, v, w, u, s, chunk=64, impl="xla")

    want = _jax_vjp(chunked, args, dy, ds)
    _close(_port(args, dy, ds), want, CHUNKED)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("T", [1, 70])
def test_wkv6_bwd_matches_torch_autograd_of_the_plain_scan(T, state):
    args, dy, ds = _inputs(2, T, 2, 8, seed=3 * T, state=state)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args
              if a is not None]
    y, s = ref.wkv6(*leaves) if state else ref.wkv6(*leaves, None)
    want = torch.autograd.grad((y, s), leaves, (torch.from_numpy(dy),
                                                torch.from_numpy(ds)))
    got = [g for g in _port(args, dy, ds) if g is not None]
    assert len(got) == len(want)
    _close([g.detach() for g in got], [w.detach() for w in want], EXACT)


def test_wkv6_bwd_bf16_inputs_match_jax_bf16_vjp():
    """bf16 r, k, v, w and dy: dr, dk, dv, dw in bf16, du and the state's
    gradient in fp32; JAX's vjp of its exact scan on the same bf16
    values."""
    args, dy, ds = _inputs(1, 40, 2, 16, seed=9, state=True)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (*args[:4], dy)]
    u, s0, dS = (torch.from_numpy(a) for a in (args[4], args[5], ds))
    got = ref.wkv6_bwd(*bf[:4], u, s0, bf[4], dS)
    assert [g.dtype for g in got] == [torch.bfloat16] * 4 \
        + [torch.float32] * 2
    jb = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in bf]
    _, pull = jax.vjp(jax_ref.wkv6, *jb[:4], jnp.asarray(args[4]),
                      jnp.asarray(args[5]))
    want = pull((jb[4], jnp.asarray(ds)))
    assert [w.dtype for w in want[:4]] == [jnp.bfloat16] * 4
    _close([g.float() for g in got], [np.asarray(w, np.float32)
                                      for w in want], 2e-2)


def test_wkv6_bwd_small_decay():
    """w in (1e-4, 0.95): the direct form rowsum(dS_t * S_{t-1}) keeps dw
    within the exact bound of JAX's vjp (a log-form dw divides by w)."""
    args, dy, ds = _inputs(2, 100, 2, 16, seed=4, state=True, w_lo=1e-4)
    assert float(args[3].min()) < 1e-3
    want = _jax_vjp(jax_ref.wkv6, args, dy, ds)
    _close(_port(args, dy, ds), want, EXACT)


def test_ops_under_grad_on_cpu_goes_through_autograd_and_launches_nothing():
    args, dy, ds = _inputs(1, 20, 2, 8, seed=2, state=True)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    before = (ops.launches, backward.launches)
    y, s = ops.wkv6(*leaves)
    got = torch.autograd.grad((y, s), leaves, (torch.from_numpy(dy),
                                               torch.from_numpy(ds)))
    assert y.grad_fn is not None and (ops.launches,
                                      backward.launches) == before
    _close([g.detach() for g in got], _port(args, dy, ds), EXACT)
    # the backward's wrapper on CPU tensors is the plain version
    plain = backward.wkv6_bwd(*(torch.from_numpy(a) for a in args),
                              torch.from_numpy(dy), torch.from_numpy(ds))
    assert backward.launches == before[1]
    _close(plain, _port(args, dy, ds), 0.0)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("T", [1, 130])
def test_the_autograd_function_routes_its_gradients(monkeypatch, T, state):
    """``ops._WKV6`` with its forward kernel replaced by the plain scan
    (a CPU test has no card): the Function saves what its backward
    needs, takes the final state's gradient as None when it is unused,
    and returns the gradient of each input in order, the state's only
    when one was given."""
    def plain_forward(r, k, v, w, u, state, out_state):
        y, s = ref.wkv6(r, k, v, w, u, state)
        return y, s, None

    monkeypatch.setattr(ops, "_forward", plain_forward)
    args, dy, ds = _inputs(1, T, 2, 8, seed=T, state=state)
    leaves = [None if a is None else torch.from_numpy(a).requires_grad_()
              for a in args]
    y, s = ops._WKV6.apply(*leaves)
    given = [t for t in leaves if t is not None]
    got = torch.autograd.grad(y, given, torch.from_numpy(dy))
    zero = np.zeros_like(ds)
    want = [g for g in _port(args, dy, zero) if g is not None]
    _close([g.detach() for g in got], want, EXACT)
    y, s = ops._WKV6.apply(*leaves)
    got = torch.autograd.grad((y, s), given, (torch.from_numpy(dy),
                                              torch.from_numpy(ds)))
    want = [g for g in _port(args, dy, ds) if g is not None]
    _close([g.detach() for g in got], want, EXACT)
