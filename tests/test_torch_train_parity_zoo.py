"""Training gradients of the port against JAX's for the routed-MoE (with
its load-balancing aux loss, checked on its own), MLA, Mamba-hybrid,
RWKV-6 and enc-dec reduced configs: loss and gnorm within 1e-5 relative,
every leaf within 1e-4 of its max |g| (fp32, CPU), remat on equal to off.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from torch_parity import check_train_grads  # noqa: E402


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "deepseek-v3-671b",
                                  "jamba-1.5-large-398b", "rwkv6-3b",
                                  "seamless-m4t-large-v2"])
def test_train_grads_match_jax(arch):
    case = check_train_grads(arch)
    if case["cfg"].moe is not None:
        # the aux term is a real part of the loss: nonzero, and 0.01 of it
        # is in the loss both packages computed
        assert case["port"][1] > 0.5
