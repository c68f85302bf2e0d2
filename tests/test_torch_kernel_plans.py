"""The launch plans of the port's decode and wkv6 kernels: pure Python,
checked here without a card.

``flash_decode.ops.plan`` deals a row's 64-key tiles round-robin to at most
8 splits (the blocks of one cluster); ``wkv6.ops.Plan`` cuts a prefill into
64-token chunks and sizes the fp32 scratch passed between its launches.
"""
from __future__ import annotations

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_decode import ops as decode_ops  # noqa: E402
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
