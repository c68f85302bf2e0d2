"""The launch plans of the port's decode, wkv6 and attention backward
kernels, and the build's source digest: pure Python, checked here without a
card.

``flash_decode.ops.plan`` deals a row's 64-key tiles round-robin to at most
8 splits (the blocks of one cluster); ``wkv6.ops.Plan`` cuts a prefill into
64-token chunks and sizes the fp32 scratch passed between its launches;
``wkv6.backward.Plan`` does the same for the gradient, over the forward's
chunks; ``flash_attention.backward.Plan`` picks the attention backward's
instance, grids and shared memory and mirrors the tiles each block walks.
"""
from __future__ import annotations

import math
import shutil

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    backward as flash_bwd)
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as decode_ops  # noqa: E402
from repro_torch.kernels.wkv6 import backward as wkv_bwd  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402


@pytest.mark.parametrize("S", [1, 65, 500, 1024, 32768])
@pytest.mark.parametrize("rows", [1, 16, 400])
@pytest.mark.parametrize("bs", [None, 1, 37, 1000])
def test_decode_plan_puts_every_tile_in_exactly_one_split(S, rows, bs):
    pl = decode_ops.plan(S, rows, 132, bs)
    assert pl.tiles == math.ceil(S / decode_ops.TILE)
    assert 1 <= pl.splits <= min(decode_ops.MAX_SPLITS, pl.tiles)
    seen = sorted(t for s in range(pl.splits) for t in pl.tiles_of(s))
    assert seen == list(range(pl.tiles))
    assert all(len(pl.tiles_of(s)) >= 1 for s in range(pl.splits))


def test_decode_plan_at_the_serve_shape():
    """Qwen2-1.5B decode: 8 slots x 2 kv heads over a 1024-key cache on 132
    SMs: 8 splits of 2 tiles each, 128 blocks; the serve mask's valid
    prefixes of 2..8 tiles spread one tile a block."""
    pl = decode_ops.plan(1024, 8 * 2, 132)
    assert (pl.tiles, pl.splits) == (16, 8)
    assert 8 * 2 * pl.splits == 128
    assert all(len(pl.tiles_of(s)) == 2 for s in range(pl.splits))
    for n in (128 + 48 * i for i in range(8)):
        valid_tiles = math.ceil(n / 64)
        busy = [sum(t < valid_tiles for t in pl.tiles_of(s))
                for s in range(pl.splits)]
        assert max(busy) == 1 and sum(busy) == valid_tiles


def test_decode_plan_rounds_bs_up_to_whole_tiles():
    assert decode_ops.plan(500, 4, 132, bs=1) \
        == decode_ops.plan(500, 4, 132, bs=64)
    assert decode_ops.plan(500, 4, 132, bs=1000).splits == 1
    assert decode_ops.plan(500, 4, 132, bs=128).splits == 4


@pytest.mark.parametrize("T,chunks", [
    (1, 0), (2, 1), (63, 1), (64, 1), (65, 2), (128, 2), (504, 8),
    (1000, 16)])
def test_wkv6_plan_chunks_and_scratch(T, chunks):
    """Chunks of 64 tokens, the last one ragged (T = 1 takes the one-token
    kernel and no chunk), and a state delta and decay per chunk."""
    pl = wkv_ops.Plan(2, T, 40, 64)
    assert pl.chunks == chunks
    if chunks:
        assert (chunks - 1) * wkv_ops.CHUNK < T <= chunks * wkv_ops.CHUNK
    assert pl.state_shape == (2, 40, chunks, 64, 64)
    assert pl.decay_shape == (2, 40, chunks, 64)
    assert pl.blocks == max(1, chunks) * 40 * 2


def test_wkv6_plan_at_the_serve_shapes():
    """RWKV6-3B: the longest prefill (B 1, T 504) runs 320 blocks a chunk
    launch, not one a head (40), with 5.2 MB of fp32 scratch; decode (B 8,
    T 1) needs none."""
    pre = wkv_ops.Plan(1, 504, 40, 64)
    assert pre.blocks == 320 and pre.blocks > 40
    scratch = 4 * (math.prod(pre.state_shape) + math.prod(pre.decay_shape))
    assert scratch == 4 * 40 * 8 * (64 * 64 + 64)
    dec = wkv_ops.Plan(8, 1, 40, 64)
    assert dec.chunks == 0 and dec.blocks == 320
    assert math.prod(dec.state_shape) == 0


def test_plans_need_no_card():
    """Every plan above ran on a machine without CUDA; the wrappers still
    take the plain versions on CPU tensors and launch nothing."""
    before = (decode_ops.launches, wkv_ops.launches)
    q, k = torch.randn(1, 4, 8), torch.randn(1, 70, 2, 8)
    valid = torch.ones(1, 70, dtype=torch.bool)
    decode_ops.decode_attention(q, k, k, valid, bs=1)
    x = torch.rand(1, 70, 2, 8)
    wkv_ops.wkv6(x, x, x, x, torch.zeros(2, 8))
    assert (decode_ops.launches, wkv_ops.launches) == before


@pytest.mark.parametrize("T,chunks", [
    (1, 1), (2, 1), (63, 1), (64, 1), (65, 2), (200, 4), (512, 8)])
def test_wkv6_backward_plan_chunks_and_scratch(T, chunks):
    """The forward's chunks of 64 tokens (T = 1 is one chunk), a gradient
    delta, a decay and a partial du per chunk; the start states it takes
    are the forward's scratch after its walk."""
    pl = wkv_bwd.Plan(2, T, 40, 64)
    assert pl.chunks == chunks
    assert (chunks - 1) * wkv_ops.CHUNK < T <= chunks * wkv_ops.CHUNK
    assert pl.grad_shape == pl.starts_shape == (2, 40, chunks, 64, 64)
    assert pl.decay_shape == (2, 40, chunks, 64)
    assert pl.blocks == chunks * 40 * 2
    if T > 1:
        assert pl.starts_shape == wkv_ops.Plan(2, T, 40, 64).state_shape


def test_wkv6_backward_plan_at_the_train_shape():
    """RWKV6-3B training (B 4, T 512, H 40, N 64): 1280 blocks a per-chunk
    launch; the start states the forward keeps for it are 21 MB a layer,
    and its own scratch as much again plus two vectors a chunk."""
    pl = wkv_bwd.Plan(4, 512, 40, 64)
    assert pl.blocks == 1280
    assert 4 * math.prod(pl.starts_shape) == 20_971_520
    scratch = 4 * (math.prod(pl.grad_shape) + 2 * math.prod(pl.decay_shape))
    assert scratch == 4 * 4 * 40 * 8 * (64 * 64 + 2 * 64)


_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype", [_F32, _BF16])
@pytest.mark.parametrize("dq_lo", range(1, 257, 32))
def test_flash_backward_plan_covers_every_head_dim(dq_lo, dtype):
    """Every (dq, dv) in 1..256 gets one of the four compiled instances
    covering both dims, and both launches fit a block's shared memory."""
    for dq in range(dq_lo, dq_lo + 32):
        for dv in range(1, 257):
            pl = flash_bwd.Plan(2, 100, 100, 4, 2, dq, dv, True, None, dtype)
            DQ, DV = pl.instance
            assert (DQ, DV) in ((64, 64), (128, 128), (192, 128), (256, 256))
            assert dq <= DQ and dv <= DV
            assert pl.smem_kv <= flash_bwd.SMEM_MAX
            assert pl.smem_q <= flash_bwd.SMEM_MAX


# chip_smoke.py's TRAIN_KERNEL_CASES: (B, T, S, H, Hkv, dq, dv, causal,
# window, dtype) -> instance, streamed rows, split, dK/dV grid, dQ grid,
# threads (dK/dV, dQ), shared memory (dK/dV, dQ)
_TRAIN_PLANS = [
    ("DeiT-Base", (32, 197, 197, 12, 12, 64, 64, False, None, _F32),
     ((64, 64), 64, 1, (4, 12, 32), (4, 12, 32), (256, 256),
      (102912, 84992))),
    ("Qwen2-1.5B", (4, 512, 512, 12, 2, 128, 128, True, None, _BF16),
     ((128, 128), 64, 2, (16, 2, 4), (8, 12, 4), (256, 128),
      (121856, 104448))),
    ("gemma3-1b", (4, 1024, 1024, 4, 1, 256, 256, True, 512, _BF16),
     ((256, 256), 64, 2, (32, 1, 4), (16, 4, 4), (256, 128),
      (220160, 202752))),
    ("MLA", (1, 512, 512, 128, 128, 192, 128, True, None, _BF16),
     ((192, 128), 64, 1, (8, 128, 1), (8, 128, 1), (256, 128),
      (146432, 86016))),
    ("cross", (8, 32, 512, 16, 16, 64, 64, False, None, _F32),
     ((64, 64), 64, 1, (8, 16, 8), (1, 16, 8), (256, 256),
      (102912, 84992))),
]


@pytest.mark.parametrize("tag,shape,want", _TRAIN_PLANS,
                         ids=[c[0] for c in _TRAIN_PLANS])
def test_flash_backward_plan_at_the_train_shapes(tag, shape, want):
    """The instance, grids and shared memory at the shapes the train path
    and the other families give the backward: MLA's dq 192 is its own
    instance (not padded to 256); Qwen2's and gemma3's groups are split
    over pairs of dK/dV blocks (64 key tiles of a kv head and batch row
    would leave half the 132 SMs idle); gemma3's d 256 in bf16 keeps two
    stages of 64 rows; fp32 at d 64 fits two blocks an SM."""
    pl = flash_bwd.Plan(*shape)
    got = (pl.instance, pl.stream, pl.split, pl.grid_kv, pl.grid_q,
           (pl.threads_kv, pl.threads_q), (pl.smem_kv, pl.smem_q))
    assert got == want


@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24, 32, 64])
@pytest.mark.parametrize("dtype", [_F32, _BF16])
def test_flash_backward_split_divides_the_group(g, dtype):
    """A pair of bf16 dK/dV blocks shares a key tile only where the group
    is even (each takes every other head, as the entry point requires)
    and the key tiles alone are fewer than the SMs; fp32 never splits."""
    for B, S in ((1, 64), (4, 512), (64, 2048)):
        pl = flash_bwd.Plan(B, S, S, 2 * g, 2, 128, 128, True, None, dtype)
        tiles = -(-S // 64) * 2 * B
        want = 2 if (dtype == _BF16 and g % 2 == 0
                     and tiles < flash_bwd.SMS) else 1
        assert pl.split == want and g % pl.split == 0
        assert pl.grid_kv == (-(-S // 64) * pl.split, 2, B)


def test_flash_backward_plan_streams_32_rows_for_wide_fp32():
    """fp32 above head dim 128 streams 32-row tiles, so the resident 64
    rows and one stage fit: 256/256 would need 266 KB at 64 rows."""
    for dims in ((256, 256), (192, 128), (129, 64)):
        pl = flash_bwd.Plan(1, 80, 80, 2, 1, *dims, True, 24, _F32)
        assert pl.stream == 32
        # rows 0..63 see keys 0..63; rows 64..79 keys 41..79 (window 24)
        assert (pl.key_tiles(0), pl.key_tiles(1)) == (range(0, 2),
                                                      range(1, 3))
    assert flash_bwd.Plan(1, 80, 80, 2, 1, 256, 256, True, 24,
                          _BF16).stream == 64


def _walked_pairs(pl, n_q, n_k, by_key):
    """(query tile, key tile) pairs, in (stream-row query tiles, TILE-key
    tiles) for the dK/dV pass (by_key) or (TILE-row, stream-key) for dQ."""
    if by_key:
        return {(qt, kt) for kt in range(n_k) for qt in pl.query_tiles(kt)}
    return {(qt, kt) for qt in range(n_q) for kt in pl.key_tiles(qt)}


def _visible_pairs(mask, rows, keys):
    """The (row tile, key tile) pairs holding a visible entry."""
    T, S = mask.shape
    nq, nk = -(-T // rows), -(-S // keys)
    pad = torch.zeros((nq * rows, nk * keys), dtype=torch.bool)
    pad[:T, :S] = mask
    hit = pad.reshape(nq, rows, nk, keys).any(dim=3).any(dim=1)
    return {tuple(ij) for ij in hit.nonzero().tolist()}


_SIZES = [1, 5, 63, 64, 65, 197, 512]
_TS = [(T, S) for S in _SIZES for T in _SIZES if T <= S] + [
    (65, 5), (197, 64), (512, 63)]        # T > S: rows without a key


@pytest.mark.parametrize("window", [None, 1, 30, 512])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T,S", _TS)
def test_flash_backward_tiles_walk_every_visible_pair(T, S, causal, window):
    """Each pass walks exactly the tile pairs that hold a visible (row,
    key) pair of ``ref._mask``: every visible pair lies in one walked pair
    of each pass (tiles partition rows and keys), and a tile whose rows
    see no key is walked by neither pass, at both streamed tile sizes
    (64: bf16 and fp32 up to d 128; 32: fp32 above)."""
    mask = flash_ref._mask(T, S, causal, window, "cpu")
    for dims, dtype in (((128, 128), _BF16), ((256, 256), _F32)):
        pl = flash_bwd.Plan(1, T, S, 2, 1, *dims, causal, window, dtype)
        n_q, n_k = -(-T // flash_bwd.TILE), -(-S // flash_bwd.TILE)
        assert _walked_pairs(pl, n_q, n_k, True) == _visible_pairs(
            mask, pl.stream, flash_bwd.TILE)
        assert _walked_pairs(pl, n_q, n_k, False) == _visible_pairs(
            mask, flash_bwd.TILE, pl.stream)
        empty = ~mask.any(dim=1)           # rows that see no key
        for qt in range(n_q):
            rows = empty[qt * flash_bwd.TILE:(qt + 1) * flash_bwd.TILE]
            if bool(rows.all()):
                assert len(pl.key_tiles(qt)) == 0


def test_build_digest_covers_headers(tmp_path):
    """The library's name hashes the ``csrc/*.cuh`` headers beside the
    ``.cu`` sources: an edited header (or source) names another library,
    so a stale build is never loaded. On a copy of the kernels' sources."""
    for src in _build.sources():
        dst = tmp_path / src.parent.parent.name / "csrc" / src.name
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
    srcs = _build.sources(tmp_path)
    assert [s.name for s in srcs] == [s.name for s in _build.sources()]
    headers = [s for s in srcs if s.suffix == ".cuh"]
    assert headers, "the attention kernels share a header"
    before = _build._digest(srcs)
    assert _build._digest(_build.sources(tmp_path)) == before
    headers[0].write_text(headers[0].read_text() + "// edited\n")
    edited = _build._digest(_build.sources(tmp_path))
    assert edited != before
    cu = next(s for s in srcs if s.suffix == ".cu")
    cu.write_text(cu.read_text() + "// edited\n")
    assert _build._digest(_build.sources(tmp_path)) not in (before, edited)
