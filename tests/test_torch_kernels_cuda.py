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
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.wkv6 import ref as wkv_ref  # noqa: E402

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
                                   (1, 7, 1), (500, 37), (2, 300, 130)])
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


def test_gram_kernel_output_is_exactly_symmetric(dev):
    """Only the upper triangle of tiles runs; the lower one is written from
    the same registers, so s2 equals its transpose bit for bit."""
    g = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 700, 300, generator=g, device=dev).to(dtype)
        before = gram_ops.launches
        s2 = gram_ops.gram(x)["s2"]
        assert gram_ops.launches == before + 1
        assert torch.equal(s2, s2.mT)


def test_gram_kernel_reads_an_unaligned_view(dev):
    """x[:, 1:] starts 4 bytes into its storage: no 16-byte copies."""
    base = torch.randn(600, 257, device=dev)
    x = base[:, 1:]
    before = gram_ops.launches
    got = gram_ops.gram(x)
    assert gram_ops.launches == before + 1
    want = gram_ref.gram(x)
    rel = (got["s2"] - want["s2"]).abs().max() / want["s2"].abs().max()
    assert rel <= 1e-5
    torch.testing.assert_close(got["s1"], x.double().sum(dim=0).float(),
                               rtol=1e-5, atol=1e-5)


def test_gram_cross_kernel_layer_stacked(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(3, 300, 130, generator=g, device=dev)
    y = torch.randn(3, 300, 70, generator=g, device=dev)
    before = gram_ops.launches
    got = gram_ops.gram_cross(x, y)
    assert gram_ops.launches == before + 1
    want = gram_ref.gram_cross(x, y)
    assert got["s2"].shape == (3, 130, 70) and got["s1"].shape == (3, 70)
    torch.testing.assert_close(got["s2"], want["s2"], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got["s1"], y.double().sum(dim=1).float(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_gram_cross_kernel_at_the_bgram_shape(dev, dtype, tol):
    """The one-traversal pass's per-sample grams at DeiT-Base: 12 layers x
    16 images x 12 groups = 2304 items of (197, 64), X^T X in one launch
    (``stats._bgram`` passes the same tensor as x and y)."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(12, 16, 12, 197, 64, generator=g, device=dev).to(dtype)
    before = gram_ops.launches_by["gram_cross", str(dtype)[6:]]
    got = gram_ops.gram_cross(x, x)
    assert gram_ops.launches_by["gram_cross", str(dtype)[6:]] == before + 1
    want = gram_ref.gram_cross(x, x)
    assert got["s2"].shape == (12, 16, 12, 64, 64)
    rel = (got["s2"] - want["s2"]).abs().max() / want["s2"].abs().max()
    assert rel <= tol, rel
    # 147,456 fp32 sums of 197 terms: one that cancels towards 0 keeps the
    # rounding of its partials (a sequential fp32 sum misses the fp64 sum
    # by 4e-5 here), so s1 too is held relative to its largest entry
    s1 = x.double().sum(dim=-2)
    rel1 = (got["s1"].double() - s1).abs().max() / s1.abs().max()
    assert rel1 <= tol, rel1


def test_gram_kernel_bf16_at_the_main_path_shape(dev):
    """The bf16 stream's MLP tap: (12 layers, 16 x 197 tokens, d_ff 3072)."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(12, 3152, 3072, generator=g, device=dev) \
        .to(torch.bfloat16)
    before = gram_ops.launches_by["gram", "bfloat16"]
    got = gram_ops.gram(x)
    assert gram_ops.launches_by["gram", "bfloat16"] == before + 1
    want = gram_ref.gram(x)
    rel = (got["s2"] - want["s2"]).abs().max() / want["s2"].abs().max()
    assert rel <= 1e-2
    assert torch.equal(got["s2"], got["s2"].mT)


def test_gram_kernel_at_the_internvl_mlp_tap(dev):
    """internvl2-26b's stacked MLP tap at 8 layers: (8, 4 x 520 tokens,
    d_ff 16384), 2^31 outputs (int64 offsets), 66,048 tile pairs."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(8, 2080, 16384, generator=g, device=dev)
    got = gram_ops.gram(x)
    assert torch.equal(got["s2"], got["s2"].mT)
    want = gram_ref.gram(x)
    rel = (got["s2"] - want["s2"]).abs().max() / want["s2"].abs().max()
    assert rel <= 1e-5
    _close_to_fp64_sums(got["s1"], x)


def _close_to_fp64_sums(s1, x):
    """Column sums of N fp32 terms against their fp64 sum: the rounding of
    N fp32 additions grows as N eps sigma (2e-4 at N 2080, sigma 1), so the
    bound is 4 N eps sigma."""
    n = x.shape[-2]
    atol = 4 * n * torch.finfo(torch.float32).eps * float(x.std())
    torch.testing.assert_close(s1, x.double().sum(dim=-2).float(),
                               rtol=1e-5, atol=atol)


def test_gram_kernel_at_the_moe_expert_items(dev):
    """qwen3-moe's per-expert moments: 8 layers x 128 experts = 1024 items
    of 160 capacity slots (10 token stages against the 4-stage ring), d
    1536, the empty slots zero; one launch, whose last partial wave is
    split over the tokens, not into nothing."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(1024, 160, 1536, generator=g, device=dev)
    x[:, 130:] = 0.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    pairs = 1024 * 12 * 13 // 2
    full, splits = gram_ops.split_plan(pairs, 160, sms)
    assert full <= pairs and (full == pairs or splits >= 2)
    before = gram_ops.launches
    got = gram_ops.gram(x)
    assert gram_ops.launches == before + 1
    want = gram_ref.gram(x)
    rel = (got["s2"] - want["s2"]).abs().max() / want["s2"].abs().max()
    assert rel <= 1e-5
    assert torch.equal(got["s2"], got["s2"].mT)
    _close_to_fp64_sums(got["s1"], x)


def test_gram_kernel_over_expert_queues_past_2_31_outputs(dev):
    """jamba's expert queues at d_expert 24576: 4 queues of 320 capacity
    slots, 4 x 24576^2 = 2.4 G outputs in one launch, past 2^31 (int64
    offsets), the empty slots zero."""
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(4, 320, 24576, generator=g, device=dev)
    x[:, 256:] = 0.0
    assert 4 * 24576 ** 2 > 2 ** 31
    got = gram_ops.gram(x)
    assert torch.equal(got["s2"], got["s2"].mT)
    for i in (0, 3):                # one queue at a time: 2 x 2.4 GB, not 2
        want = gram_ref.gram(x[i:i + 1])
        rel = (got["s2"][i] - want["s2"][0]).abs().max() \
            / want["s2"].abs().max()
        assert rel <= 1e-5
    _close_to_fp64_sums(got["s1"], x)


def test_gram_kernel_at_the_seamless_mlp_tap(dev):
    """seamless-m4t-large-v2's stacked MLP tap of a calibration batch: 24
    layers of 8 x 512 tokens of d_ff 8192 in one launch (6.4 GB of s2),
    each layer held to its plain gram."""
    g = torch.Generator(device=dev).manual_seed(22)
    x = torch.randn(24, 4096, 8192, generator=g, device=dev)
    before = gram_ops.launches
    got = gram_ops.gram(x)
    assert gram_ops.launches == before + 1
    for i in (0, 23):
        want = gram_ref.gram(x[i:i + 1])
        rel = (got["s2"][i] - want["s2"][0]).abs().max() \
            / want["s2"].abs().max()
        assert rel <= 1e-5
        assert torch.equal(got["s2"][i], got["s2"][i].mT)
    _close_to_fp64_sums(got["s1"], x)


def _flash_case(dev, dtype, tol, B, T, S, H, Hkv, dq, dv, causal, window,
                scale=0.125, offset=0):
    """Kernel vs plain on seeded inputs; ``offset`` > 0 makes q, k, v views
    that start that many elements into their storage."""
    g = torch.Generator(device=dev).manual_seed(T * 1000 + dq)

    def rand(*shape):
        full = torch.randn(*shape[:-1], shape[-1] + offset, generator=g,
                           device=dev).to(dtype)
        return full[..., offset:]

    q, k, v = rand(B, T, H, dq), rand(B, S, Hkv, dq), rand(B, S, Hkv, dv)
    before = flash_ops.launches
    got = flash_ops.attention(q, k, v, causal=causal, window=window,
                              scale=scale)
    want = flash_ref.attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    assert flash_ops.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, T, H, dv)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("B,T,S,H,Hkv,dq,dv,causal,window", [
    (2, 197, 197, 12, 12, 64, 64, False, None),
    (2, 197, 197, 12, 12, 32, 64, False, None),
    (1, 130, 130, 8, 2, 64, 64, True, None),
    (1, 200, 200, 4, 4, 32, 48, True, 37),
    (1, 50, 260, 2, 1, 128, 128, True, None),
    (1, 90, 90, 3, 3, 40, 24, False, None),
    (1, 150, 150, 4, 1, 256, 256, True, 37),       # d 256, one stage
    (1, 70, 200, 2, 1, 128, 256, True, None),      # dq 128 != dv 256
    (1, 90, 90, 2, 2, 256, 128, False, None),
])
def test_flash_kernel_matches_plain(dev, B, T, S, H, Hkv, dq, dv, causal,
                                    window):
    _flash_case(dev, torch.float32, 1e-4, B, T, S, H, Hkv, dq, dv, causal,
                window)


@pytest.mark.parametrize("B,T,S,H,Hkv,dq,dv,causal,window", [
    (1, 512, 512, 12, 2, 128, 128, True, None),    # Qwen2-1.5B prefill
    (2, 197, 197, 12, 12, 64, 64, False, None),    # DeiT, ragged T
    (1, 70, 300, 4, 2, 64, 64, True, None),        # T < S, right-aligned
    (1, 200, 200, 4, 4, 32, 48, True, 37),         # sliding window
    (2, 130, 130, 4, 4, 40, 64, False, None),      # dq 40 != dv 64
    (1, 100, 100, 2, 2, 8, 8, True, None),         # head dim 8
    (2, 1024, 1024, 4, 1, 256, 256, True, 512),    # gemma3 window layer
    (1, 600, 600, 4, 1, 256, 256, True, 100),      # window not a tile multiple
    (1, 300, 700, 4, 1, 128, 256, True, None),     # pruned gemma3, T < S
    (1, 130, 130, 2, 2, 200, 256, False, None),    # ragged dims above 128
    (1, 77, 77, 4, 2, 256, 96, True, 30),          # dq 256 != dv 96
    (4, 520, 520, 48, 8, 128, 128, True, None),    # internvl, 8 + 512
    (2, 512, 512, 64, 4, 128, 128, True, None),    # qwen3-moe, group 16
    (2, 512, 512, 64, 8, 128, 128, True, None),    # jamba, group 8
    (2, 300, 300, 64, 8, 64, 128, True, None),     # pruned jamba, q/k 64
])
def test_flash_kernel_bf16_matches_plain(dev, B, T, S, H, Hkv, dq, dv,
                                         causal, window):
    """The tensor-core kernel rounds P to bf16 for the P V product (the
    Pallas kernel keeps it fp32): held to the bf16 gate, 2e-2."""
    _flash_case(dev, torch.bfloat16, 2e-2, B, T, S, H, Hkv, dq, dv, causal,
                window, scale=dq ** -0.5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,dq", [(2, 512, 192), (1, 300, 192),
                                    (2, 512, 128)])
def test_flash_kernel_at_the_mla_prefill(dev, B, T, dq, dtype, tol):
    """deepseek-v3's MLA prefill: MHA over 128 heads, q and k of (nope |
    rope) = 192 dims (128 when the nope block is pruned to 64) against v of
    128, causal, at the dense model's scale 1/sqrt(192) in both cases."""
    _flash_case(dev, dtype, tol, B, T, T, 128, 128, dq, 128, True, None,
                scale=192 ** -0.5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_reads_unaligned_views(dev, dtype, tol):
    """q, k, v one element into their storage: element loads, no copy."""
    _flash_case(dev, dtype, tol, 2, 150, 150, 4, 2, 64, 64, True, None,
                offset=1)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,S", [(24, 512), (700, 512), (33, 500)])
@pytest.mark.parametrize("dq", [64, 32])
def test_flash_kernel_at_the_cross_attention(dev, T, S, dq, dtype, tol):
    """seamless-m4t-large-v2's cross attention: T decoder rows against S
    memory rows, non-causal (every key visible), T < S and T > S and S not
    a tile multiple, MHA 16/16, q/k 64 (32 when pruned) against v 64, at
    the dense model's scale 1/sqrt(64) passed in, not derived from dq."""
    _flash_case(dev, dtype, tol, 2, T, S, 16, 16, dq, 64, False, None,
                scale=64 ** -0.5)


def test_flash_kernel_refuses_wide_heads(dev):
    q = torch.randn(1, 4, 1, 264, device=dev)
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
    (2, 300, 24, 2, 64, 64),        # group of 12: two sets of warps
    (1, 200, 32, 1, 128, 128),      # group of 32: four sets, two mma tiles
    (8, 512, 4, 1, 256, 256),       # gemma3 window ring, d 256
    (8, 2048, 4, 1, 128, 256),      # pruned gemma3 global layer
    (2, 300, 8, 2, 256, 128),       # dq 256 != dv 128
    (3, 77, 8, 1, 200, 256),        # ragged dims above 128
    (8, 2048, 48, 8, 128, 128),     # internvl2-26b, group 6
    (8, 2048, 48, 8, 64, 128),      # pruned internvl2-26b
    (8, 2048, 64, 4, 128, 128),     # qwen3-moe, group 16
    (8, 2048, 64, 4, 64, 128),      # pruned qwen3-moe
    (8, 2048, 64, 8, 128, 128),     # jamba-1.5-large-398b, group 8
    (8, 2048, 64, 8, 64, 128),      # pruned jamba
])
def test_decode_kernel_matches_plain(dev, B, S, H, Hkv, dq, dv, dtype, tol):
    q, k, v, valid = _decode_inputs(dev, B, S, H, Hkv, dq, dv, dtype)
    before = decode_ops.launches
    got = decode_ops.decode_attention(q, k, v, valid, scale=0.088)
    want = decode_ref.decode_attention(q, k, v, valid, 0.088)
    assert decode_ops.launches == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dq", [64, 32])
def test_decode_kernel_over_the_cross_memory(dev, dq, dtype, tol):
    """seamless's decode cross attention: one decoder token a slot against
    its 500 memory rows (not a multiple of the 64-key tile), every key
    valid, 16/16 heads, q/k 64 (32 pruned) against v 64, scale
    1/sqrt(64); read from one layer's slice of the stacked memory K/V."""
    g = torch.Generator(device=dev).manual_seed(dq)
    B, S = 8, 500
    q = torch.randn(B, 16, dq, generator=g, device=dev).to(dtype)
    k = torch.randn(3, B, S, 16, dq, generator=g, device=dev).to(dtype)[1]
    v = torch.randn(3, B, S, 16, 64, generator=g, device=dev).to(dtype)[1]
    valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    before = decode_ops.launches
    got = decode_ops.decode_attention(q, k, v, valid, scale=0.125)
    want = decode_ref.decode_attention(q, k, v, valid, 0.125)
    assert decode_ops.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, 16, 64)
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


def _decode_case(dev, valid, dtype=torch.bfloat16, H=12, Hkv=2, d=128,
                 seed=3):
    """Kernel vs plain at one launch on a given mask; returns the output."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, S = valid.shape
    q = torch.randn(B, H, d, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, d, generator=g, device=dev).to(dtype)
    before = decode_ops.launches
    got = decode_ops.decode_attention(q, k, v, valid, scale=d ** -0.5)
    assert decode_ops.launches == before + 1
    want = decode_ref.decode_attention(q, k, v, valid, d ** -0.5)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("holes", ["first", "middle", "last", "all_but_one"])
def test_decode_kernel_skips_whole_masked_tiles(dev, holes, dtype):
    """Whole 64-key tiles without a valid key are never loaded; the tiles
    around them must still give the plain result."""
    B, S = 4, 1000                       # 16 tiles, the last one ragged
    valid = torch.ones(B, S, dtype=torch.bool, device=dev)
    if holes == "first":
        valid[:, :64] = False
    elif holes == "middle":
        valid[:, 320:448] = False
        valid[1, 100:500] = False
    elif holes == "last":
        valid[:, 960:] = False
    else:                                # one valid key in tile 9 alone
        valid[:] = False
        valid[:, 9 * 64 + 17] = True
    _decode_case(dev, valid, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_row_valid_only_at_key_zero(dev, dtype):
    valid = torch.ones(3, 700, dtype=torch.bool, device=dev)
    valid[0] = False
    valid[0, 0] = True
    valid[2, 1:] = False
    _decode_case(dev, valid, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_row_with_no_valid_key_gives_zero(dev, dtype):
    """Row 1 has no valid key: 0 on the card, as the plain version gives;
    the other rows are the plain result."""
    valid = torch.ones(3, 300, dtype=torch.bool, device=dev)
    valid[1] = False
    valid[2, 150:] = False
    got = _decode_case(dev, valid, dtype)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    assert bool(got[0].abs().max() > 0) and bool(got[2].abs().max() > 0)


def test_decode_kernel_at_the_serve_mask(dev):
    """The serve step's eight slots at lengths 128 + 48 i of 1024."""
    lens = torch.tensor([128 + 48 * i for i in range(8)], device=dev)
    valid = torch.arange(1024, device=dev)[None] < lens[:, None]
    _decode_case(dev, valid)


def test_decode_kernel_skips_tiles_of_a_strided_cache_slice(dev):
    """One layer of a stacked (layers, B, S, Hkv, d) bf16 cache with an
    int8 mask of whole masked tiles, as a decode step passes it."""
    g = torch.Generator(device=dev).manual_seed(4)
    k = torch.randn(3, 4, 512, 2, 128, generator=g,
                    device=dev).to(torch.bfloat16)
    v = torch.randn(3, 4, 512, 2, 128, generator=g,
                    device=dev).to(torch.bfloat16)
    q = torch.randn(4, 12, 128, generator=g, device=dev).to(torch.bfloat16)
    valid = (torch.arange(512, device=dev)[None] < torch.tensor(
        [[1], [64], [200], [512]], device=dev))
    valid[3, 128:256] = False
    valid = valid.to(torch.int8)
    before = decode_ops.launches
    got = decode_ops.decode_attention(q, k[2], v[2], valid)
    assert decode_ops.launches == before + 1
    want = decode_ref.decode_attention(q, k[2], v[2], valid, 128 ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_decode_kernel_reads_unaligned_views(dev, dtype, tol):
    """q, k, v one element into their storage: element loads into the same
    ring, with whole masked tiles skipped."""
    g = torch.Generator(device=dev).manual_seed(6)

    def rand(*shape):
        full = torch.randn(*shape[:-1], shape[-1] + 1, generator=g,
                           device=dev).to(dtype)
        return full[..., 1:]

    q, k, v = rand(2, 8, 64), rand(2, 300, 2, 64), rand(2, 300, 2, 64)
    valid = torch.ones(2, 300, dtype=torch.bool, device=dev)
    valid[0, 64:192] = False
    before = decode_ops.launches
    got = decode_ops.decode_attention(q, k, v, valid)
    assert decode_ops.launches == before + 1
    want = decode_ref.decode_attention(q, k, v, valid, 0.125)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_is_deterministic(dev, dtype):
    """The splits merge in split order inside their cluster: two calls are
    bitwise equal."""
    lens = torch.tensor([128 + 48 * i for i in range(8)], device=dev)
    valid = torch.arange(1024, device=dev)[None] < lens[:, None]
    valid[0, 5] = False
    once = _decode_case(dev, valid, dtype)
    again = _decode_case(dev, valid, dtype)
    assert torch.equal(once, again)


def test_decode_kernel_refuses_what_it_does_not_take(dev):
    q = torch.randn(1, 4, 264, device=dev)
    k = torch.randn(1, 8, 4, 264, device=dev)
    valid = torch.ones(1, 8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        decode_ops.decode_attention(q, k, k, valid)
    q = torch.randn(1, 64, 16, device=dev)
    k = torch.randn(1, 8, 1, 16, device=dev)
    with pytest.raises(ValueError):               # group of 64 > 32
        decode_ops.decode_attention(q, k, k, valid)


def _wkv_inputs(dev, B, T, H, N, dtype, seed=0, state=False):
    """r, k, v normal, w in (0.35, 0.95), u small, an optional state."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    r, k, v = (randn(B, T, H, N).to(dtype) for _ in range(3))
    w = (0.35 + 0.6 * torch.sigmoid(randn(B, T, H, N))).to(dtype)
    u = 0.1 * randn(H, N)
    return r, k, v, w, u, randn(B, H, N, N) if state else None


def _wkv_close(got, want, dtype):
    """y within 1e-3 abs and rel in fp32 (the JAX package's kernel-vs-ref
    bound), 2e-2 for bf16 outputs; the fp32 state within 1e-3 of its
    largest entry."""
    (gy, gs), (wy, ws) = got, want
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    assert gy.dtype == dtype and gs.dtype == torch.float32
    torch.testing.assert_close(gy.float(), wy.float(), rtol=tol, atol=tol)
    assert float((gs - ws).abs().max()) <= 1e-3 * float(ws.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,N,state", [
    (1, 504, 40, 64, False),        # the longest serve prefill (RWKV6-3B)
    (2, 200, 4, 64, True),          # ragged T with an initial state
    (2, 64, 3, 64, True),           # one whole chunk
    (3, 1, 5, 64, True),            # one token from a state
    (2, 77, 4, 16, True),           # the reduced model's head dim
])
def test_wkv6_kernel_matches_plain(dev, B, T, H, N, state, dtype):
    r, k, v, w, u, s0 = _wkv_inputs(dev, B, T, H, N, dtype, seed=T,
                                    state=state)
    before = wkv_ops.launches
    got = wkv_ops.wkv6(r, k, v, w, u, s0)
    assert wkv_ops.launches == before + 1
    _wkv_close(got, wkv_ref.wkv6(r, k, v, w, u, s0), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_updates_a_stacked_state_slice_in_place(dev, dtype):
    """The decode step: T = 1 over one layer of the stacked (reps, B, H, N,
    N) cache, r/k/v/w as strided views of a (B, T, D) projection."""
    B, H, N = 8, 40, 64
    stacked = torch.randn(3, B, H, N, N, device=dev)
    keep = stacked[[0, 2]].clone()
    proj = torch.randn(B, 1, 4 * H * N, device=dev).to(dtype)
    r, k, v, w = (proj[..., i * H * N:(i + 1) * H * N].reshape(B, 1, H, N)
                  for i in range(4))
    w = (0.35 + 0.6 * torch.sigmoid(w.float())).to(dtype)
    u = 0.1 * torch.randn(H, N, device=dev)
    want = wkv_ref.wkv6(r, k, v, w, u, stacked[1].clone())
    y, s = wkv_ops.wkv6(r, k, v, w, u, stacked[1], out_state=stacked[1])
    assert s.data_ptr() == stacked[1].data_ptr()
    _wkv_close((y, stacked[1]), want, dtype)
    torch.testing.assert_close(stacked[[0, 2]], keep, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("T", [1, 2, 15, 16, 17, 63, 64, 65, 128, 504, 1000])
def test_wkv6_kernel_chunk_and_sub_chunk_edges(dev, T, state, dtype):
    """Ragged T around the 16-token sub-chunks and 64-token chunks, from
    zeros and from a state: the one-token kernel at T = 1, the
    chunk-parallel prefill above it."""
    r, k, v, w, u, s0 = _wkv_inputs(dev, 2, T, 3, 64, dtype, seed=T,
                                    state=state)
    before = wkv_ops.launches
    got = wkv_ops.wkv6(r, k, v, w, u, s0)
    assert wkv_ops.launches == before + 1
    _wkv_close(got, wkv_ref.wkv6(r, k, v, w, u, s0), dtype)


def test_wkv6_kernel_batch_one_many_chunks(dev):
    """B = 1 over 16 chunks at RWKV6-3B's 40 heads: 640 blocks a launch."""
    r, k, v, w, u, s0 = _wkv_inputs(dev, 1, 1000, 40, 64, torch.bfloat16,
                                    seed=5, state=True)
    assert wkv_ops.Plan(1, 1000, 40, 64).blocks == 640
    _wkv_close(wkv_ops.wkv6(r, k, v, w, u, s0),
               wkv_ref.wkv6(r, k, v, w, u, s0), torch.bfloat16)


@pytest.mark.parametrize("T", [1, 100])
def test_wkv6_kernel_in_place_through_both_kernels(dev, T):
    """In place on one layer of a stacked state: the one-token kernel (T =
    1) and the prefill (T = 100) leave the other layers untouched."""
    B, H, N = 2, 4, 64
    stacked = torch.randn(3, B, H, N, N, device=dev)
    keep = stacked[[0, 2]].clone()
    r, k, v, w, u, _ = _wkv_inputs(dev, B, T, H, N, torch.float32, seed=9)
    want = wkv_ref.wkv6(r, k, v, w, u, stacked[1].clone())
    y, s = wkv_ops.wkv6(r, k, v, w, u, stacked[1], out_state=stacked[1])
    assert s.data_ptr() == stacked[1].data_ptr()
    _wkv_close((y, stacked[1]), want, torch.float32)
    torch.testing.assert_close(stacked[[0, 2]], keep, rtol=0, atol=0)


@pytest.mark.parametrize("T", [1, 300])
def test_wkv6_kernel_is_deterministic(dev, T):
    r, k, v, w, u, s0 = _wkv_inputs(dev, 2, T, 8, 64, torch.bfloat16,
                                    seed=11, state=True)
    y1, s1 = wkv_ops.wkv6(r, k, v, w, u, s0)
    y2, s2 = wkv_ops.wkv6(r, k, v, w, u, s0)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.parametrize("T", [1, 150])
def test_wkv6_kernel_reads_a_strided_n_view(dev, T):
    """r, k, v, w with an n-stride of 2: element loads, no copy."""
    B, H, N = 2, 3, 32
    g = torch.Generator(device=dev).manual_seed(12)
    base = torch.randn(4, B, T, H, 2 * N, generator=g, device=dev)
    base[3] = 0.35 + 0.6 * torch.sigmoid(base[3])
    r, k, v, w = (base[i, ..., ::2] for i in range(4))
    assert r.stride(-1) == 2
    u = 0.1 * torch.randn(H, N, generator=g, device=dev)
    s0 = torch.randn(B, H, N, N, generator=g, device=dev)
    _wkv_close(wkv_ops.wkv6(r, k, v, w, u, s0),
               wkv_ref.wkv6(r, k, v, w, u, s0), torch.float32)


def test_wkv6_kernel_without_a_state_starts_from_zeros(dev):
    r, k, v, w, u, _ = _wkv_inputs(dev, 2, 90, 3, 32, torch.float32)
    zeros = torch.zeros(2, 3, 32, 32, device=dev)
    y0, s0 = wkv_ops.wkv6(r, k, v, w, u)
    y1, s1 = wkv_ops.wkv6(r, k, v, w, u, zeros)
    torch.testing.assert_close(y0, y1, rtol=0, atol=0)
    torch.testing.assert_close(s0, s1, rtol=0, atol=0)


def test_wkv6_kernel_refuses_what_it_does_not_take(dev):
    r, k, v, w, u, s = _wkv_inputs(dev, 1, 8, 2, 80, torch.float32,
                                   state=True)
    with pytest.raises(ValueError):               # head dim 80 > 64
        wkv_ops.wkv6(r, k, v, w, u, s)
    r, k, v, w, u, s = _wkv_inputs(dev, 2, 8, 2, 16, torch.float32,
                                   state=True)
    with pytest.raises(TypeError):                # mixed dtypes
        wkv_ops.wkv6(r, k.to(torch.bfloat16), v, w, u)
    with pytest.raises(ValueError):               # a bf16 state
        wkv_ops.wkv6(r, k, v, w, u, s.to(torch.bfloat16))
    big = torch.zeros(3, 2, 16, 16, device=dev)
    with pytest.raises(ValueError):               # overlapping, not equal
        wkv_ops.wkv6(r, k, v, w, u, big[:2], out_state=big[1:])
