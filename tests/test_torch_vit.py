"""The port's ViT forward against the JAX reference, on the same weights.

JAX params are carried across by ``repro_torch.interop`` (numpy, identical
key paths). Both sides run fp32 on the CPU; matmuls sum in different
orders, so logits and taps are held to rtol 1e-4, atol 1e-5.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.ckpt import _flatten  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.common import activation as jax_activation  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from repro_torch.models.common import activation  # noqa: E402
from torch_parity import images, jax_params, port_cfg  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def run_both(cfg, params_np, x):
    jt, pt = {}, {}
    want = jax_build(cfg).apply(jax.tree.map(jnp.asarray, params_np),
                                {"images": jnp.asarray(x)}, taps=jt)
    port = pt_build(port_cfg(cfg))
    got = port.apply(interop.from_numpy(params_np, device="cpu"),
                     {"images": torch.from_numpy(x)}, taps=pt)
    return want, jt, got, pt


@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config("deit-base"))


def test_interop_round_trip_keeps_jax_key_paths(cfg):
    params = jax_params(cfg)
    pt = interop.from_numpy(params, device="cpu")
    back = interop.to_numpy(pt)
    want, _ = _flatten(params)
    got = interop.flatten(back)
    assert list(got) == sorted(want)
    assert "seg0/p0/mixer/wq" in got
    assert got["seg0/p0/mixer/wq"].shape[0] == cfg.n_layers
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)


def test_logits_and_taps_match_jax(cfg):
    params = jax_params(cfg)
    x = images(cfg)
    want, jt, got, pt = run_both(cfg, params, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert sorted(pt) == sorted(jt) == ["seg0/p0/h", "seg0/p0/k",
                                        "seg0/p0/q"]
    for k in jt:
        assert tuple(pt[k].shape) == jt[k].shape, k
        assert pt[k].shape[0] == cfg.n_layers
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(jt[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_pruned_widths_keep_the_dense_attention_scale(cfg):
    """A pruned model (qk 16 -> 8, d_ff 256 -> 128) still scales logits by
    1/sqrt(qk_full) = 1/4, as the JAX model does (attention.py:138)."""
    pcfg = cfg.pruned(0.5, 0.5)
    assert pcfg.eff_qk == 8 and pcfg.qk_full == 16
    params = jax_params(pcfg, seed=3)
    x = images(pcfg, seed=4)
    want, _, got, _ = run_both(pcfg, params, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(jax_activation("gelu")(jnp.asarray(x)))
    got = activation("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4   # the erf form would differ
