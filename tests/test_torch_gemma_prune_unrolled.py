"""The port's class-3 pruning of gemma3-1b against the JAX package at 8
layers: one scanned segment of 6 plus 2 unrolled layers, the shape of the
full model's 4 x 6 + 2. Every case of ``test_torch_gemma_prune.py`` that
takes its ``s`` fixture runs here on the 8-layer setup, with that file's
tolerances (it runs them at 6 layers); the two files are split so that
two workers share them.
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import test_torch_gemma_prune as base  # noqa: E402
from repro.core import discover_units as jax_units  # noqa: E402
from repro_torch.core import discover_units  # noqa: E402
from test_torch_gemma_prune import (  # noqa: E402,F401
    test_class3_pass2_statistics_match_jax,
    test_compensated_qk_scales_multiply_to_one_plus_m,
    test_keep_sets_identical_to_jax, test_one_traversal_matches_jax_and_two_pass,
    test_pass1_sums_match_jax, test_pruned_logits_match_jax,
    test_spec_reconstruct_class3_equals_the_ports_pass2,
    test_speculative_sums_match_jax)


@pytest.fixture(scope="module", params=[8])
def s(request):
    return base._s(request.param)


def test_units_are_class3_stacked_and_unrolled():
    s = base._s(8)
    units = discover_units(s["cfg"])
    assert [dataclasses.asdict(u) for u in units] == \
        [dataclasses.asdict(u) for u in jax_units(s["jcfg"])]
    attn = base._attn_units(units)
    assert {u.attn_class for u in attn} == {3}
    assert [(u.name, u.stacked, u.reps) for u in attn[-2:]] == \
        [("seg1/l0/attn", False, 1), ("seg1/l1/attn", False, 1)]
    assert sum(u.stacked for u in units) == 12 and len(units) == 16
