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
    x = torch.randn(shape, device=dev).to(dtype)
    before = gram_ops.launches
    got = gram_ops.gram(x)
    want = gram_ref.gram(x)
    assert gram_ops.launches == before + 1
    rel = (got["s2"] - want["s2"]).abs().max() / want["s2"].abs().max()
    assert rel <= tol
    torch.testing.assert_close(got["s1"], want["s1"], rtol=tol, atol=tol)


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
