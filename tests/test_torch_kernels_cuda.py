"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA card is present (the fixture
decides at run time). On a machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ref as decode_ref  # noqa: E402
from repro_torch.kernels.gram import ops as gram_ops  # noqa: E402
from repro_torch.kernels.gram import ref as gram_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(394, 192), (1000, 40), (2, 129, 300),
                                   (1, 7, 1)])
def test_gram_kernel_matches_plain(dev, shape, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    before = gram_ops.launches
    got = gram_ops.gram(x)
    want = gram_ref.gram(x)
    assert gram_ops.launches == before + 1
    rel = (got["s2"] - want["s2"]).abs().max() / want["s2"].abs().max()
    assert rel <= tol
    # two fp32 sums of 1000 terms in different orders can differ by 2e-5
    # where a column cancels: hold the column sums to the fp64 sum of the
    # same inputs, so only the kernel's rounding is compared
    torch.testing.assert_close(got["s1"], x.double().sum(dim=-2).float(),
                               rtol=tol, atol=tol)


def test_gram_cross_kernel_reads_strided_inputs(dev):
    base = torch.randn(300, 90, device=dev)
    x, y = base[:, :40], base[:, 50:].t().contiguous().t()
    got = gram_ops.gram_cross(x, y)
    want = gram_ref.gram_cross(x, y)
    torch.testing.assert_close(got["s2"], want["s2"], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got["s1"], want["s1"], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("B,T,S,H,Hkv,dq,dv,causal,window", [
    (2, 197, 197, 12, 12, 64, 64, False, None),
    (2, 197, 197, 12, 12, 32, 64, False, None),
    (1, 130, 130, 8, 2, 64, 64, True, None),
    (1, 200, 200, 4, 4, 32, 48, True, 37),
    (1, 50, 260, 2, 1, 128, 128, True, None),
])
def test_flash_kernel_matches_plain(dev, B, T, S, H, Hkv, dq, dv, causal,
                                    window):
    q = torch.randn(B, T, H, dq, device=dev)
    k = torch.randn(B, S, Hkv, dq, device=dev)
    v = torch.randn(B, S, Hkv, dv, device=dev)
    before = flash_ops.launches
    got = flash_ops.attention(q, k, v, causal=causal, window=window,
                              scale=0.125)
    want = flash_ref.attention(q, k, v, causal=causal, window=window,
                               scale=0.125)
    assert flash_ops.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_flash_kernel_refuses_wide_heads(dev):
    q = torch.randn(1, 4, 1, 160, device=dev)
    with pytest.raises(ValueError):
        flash_ops.attention(q, q, q)


def _decode_inputs(dev, B, S, H, Hkv, dq, dv, dtype=torch.float32, seed=0):
    """Row 0 has holes, row 1 a whole invalid 64-key tile and an invalid
    tail; every other row is a prefix, as in the serve cache."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, dq, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, dq, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, dv, generator=g, device=dev).to(dtype)
    idx = torch.arange(S, device=dev)
    valid = idx[None, :] < torch.randint(1, S + 1, (B, 1), generator=g,
                                         device=dev)
    valid[0] = torch.rand(S, generator=g, device=dev) < 0.7
    valid[0, 0] = True
    if B > 1:
        valid[1] = True
        valid[1, 64:128] = False
        valid[1, S - 70:] = False
    return q, k, v, valid


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,Hkv,dq,dv", [
    (8, 1024, 12, 2, 128, 128),     # the serve path's shape (Qwen2-1.5B)
    (8, 1024, 12, 2, 64, 128),      # pruned: dq 64, dv 128
    (2, 300, 4, 1, 16, 16),         # GQA 4/1, ragged S
    (2, 200, 4, 4, 32, 32),         # MHA
    (3, 77, 8, 2, 8, 24),           # dq != dv, S under two tiles
])
def test_decode_kernel_matches_plain(dev, B, S, H, Hkv, dq, dv, dtype, tol):
    q, k, v, valid = _decode_inputs(dev, B, S, H, Hkv, dq, dv, dtype)
    before = decode_ops.launches
    got = decode_ops.decode_attention(q, k, v, valid, scale=0.088)
    want = decode_ref.decode_attention(q, k, v, valid, 0.088)
    assert decode_ops.launches == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_decode_kernel_reads_a_strided_cache_slice(dev):
    """A decode step passes one layer of the stacked (reps, B, S, Hkv, d)
    cache and an int8 mask: no copy is needed."""
    k = torch.randn(3, 4, 256, 2, 64, device=dev)
    v = torch.randn(3, 4, 256, 2, 64, device=dev)
    q = torch.randn(4, 6, 64, device=dev)
    valid = (torch.arange(256, device=dev)[None] < torch.tensor(
        [[1], [64], [200], [256]], device=dev)).to(torch.int8)
    got = decode_ops.decode_attention(q, k[1], v[1], valid)
    want = decode_ref.decode_attention(q, k[1], v[1], valid, 0.125)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bs", [1, 37, 64, 128, 1000])
def test_decode_kernel_split_invariance(dev, bs):
    """The logsumexp merge makes the result independent of the split
    size, down to one key per split."""
    q, k, v, valid = _decode_inputs(dev, 2, 500, 8, 2, 64, 64)
    one = decode_ops.decode_attention(q, k, v, valid, bs=500)
    got = decode_ops.decode_attention(q, k, v, valid, bs=bs)
    torch.testing.assert_close(got, one, rtol=1e-5, atol=1e-5)


def test_decode_kernel_refuses_what_it_does_not_take(dev):
    q = torch.randn(1, 4, 160, device=dev)
    k = torch.randn(1, 8, 4, 160, device=dev)
    valid = torch.ones(1, 8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        decode_ops.decode_attention(q, k, k, valid)
    q = torch.randn(1, 64, 16, device=dev)
    k = torch.randn(1, 8, 1, 16, device=dev)
    with pytest.raises(ValueError):               # group of 64 > 32
        decode_ops.decode_attention(q, k, k, valid)
