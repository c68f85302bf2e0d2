"""The port's serving front-end against the JAX package's on the recurrent
slot-cache contract: rwkv6-3b and jamba-1.5-large-398b reduced, whose
prefix cache reuses whole-prompt state snapshots (the first chunk's state
under its exact tokens, and each installed prompt's state). The trace,
clock and checks are those of ``tests/test_torch_serve_frontend.py``
(``torch_serve_parity.check_frontend_parity``); a chunk of 8 tokens is the
smallest that still inserts a first-chunk snapshot (a chunk is quantised
to a multiple of the smallest bucket, 8).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from torch_serve_parity import check_frontend_parity  # noqa: E402


@pytest.mark.parametrize("arch,spf,chunk", [
    ("rwkv6-3b", False, None), ("rwkv6-3b", True, 8),
    ("jamba-1.5-large-398b", False, None)])
def test_frontend_matches_the_jax_frontend(arch, spf, chunk):
    check_frontend_parity(arch, spf, chunk)
