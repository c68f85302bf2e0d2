"""Training gradients of the port against JAX's, on the CPU: the loss, the
global gradient norm and every leaf's gradient of one batch, for the
dense families' reduced configs (fp32, the same numpy weights; the batch
from each package's ``launch.train.data_for``), with remat on equal to
remat off. The MoE, MLA, Mamba, RWKV and enc-dec configs are in
``test_torch_train_parity_zoo.py``."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from torch_parity import check_train_grads  # noqa: E402


@pytest.mark.parametrize("arch", ["deit-base", "qwen2-1.5b", "gemma3-1b",
                                  "internvl2-26b", "granite-8b",
                                  "deepseek-7b"])
def test_train_grads_match_jax(arch):
    check_train_grads(arch)
