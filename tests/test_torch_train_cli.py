"""The port's training CLI against JAX's ``launch.train`` across a
checkpoint: JAX trains 3 steps and saves; the port resumes a copy
(``--device cpu``) to step 6 while JAX resumes another copy; the losses of
steps 4-6 agree and JAX restores the port's step-6 checkpoint. Plus the
CLI's refusals."""
from __future__ import annotations

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch.launch import train as pt_train  # noqa: E402

CASES = {"deit-base": ["--batch", "8"],
         "qwen2-1.5b": ["--batch", "4", "--seq", "16"]}


@pytest.mark.parametrize("arch", sorted(CASES))
def test_port_resumes_jax_checkpoint_and_jax_restores_port(arch, tmp_path):
    cfg = reduced(get_config(arch))
    flags = CASES[arch]
    batch = int(flags[1])
    seq = int(flags[3]) if len(flags) > 2 else 64
    first = tmp_path / "first"
    jax_train.train(cfg, steps=3, batch=batch, seq=seq, ckpt_dir=str(first),
                    save_every=3, log=lambda *a: None)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(first, port_dir)
    shutil.copytree(first, jax_dir)
    _, _, got = pt_train.main(["--arch", arch + "-reduced", "--steps", "6",
                               "--save-every", "3", "--ckpt", str(port_dir),
                               "--device", "cpu", *flags])
    jparams, jopt, want = jax_train.train(
        cfg, steps=6, batch=batch, seq=seq, ckpt_dir=str(jax_dir),
        save_every=3, log=lambda *a: None)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    like = jax_build(cfg).init(jax.random.PRNGKey(0))
    (rp, ro), _ = jax_restore(str(port_dir), 6, (like, jax_adamw_init(like)))
    assert int(ro["step"]) == int(jopt["step"]) == 6
    # every leaf within 1e-3 of its max |p|; a zero-initialised leaf whose
    # gradient is analytically zero (the key bias bk: softmax is
    # shift-invariant) moves only by Adam-normalised rounding noise and
    # stays below 1e-3 of the largest |p| in both packages
    top = max(float(np.abs(np.asarray(b, np.float32)).max())
              for b in jax.tree.leaves(jparams))
    for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(jparams)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        m = float(np.abs(b).max())
        if m < 1e-3 * top:
            assert float(np.abs(a).max()) < 1e-3 * top
        else:
            assert np.abs(a - b).max() <= 1e-3 * m
    # the moments restore into JAX's template, shapes and dtypes (their
    # values follow the gradients, whose near-zero leaves Adam's
    # normalisation amplifies: the optimizer is held to JAX on identical
    # gradients in test_torch_optim.py)
    for a, b in zip(jax.tree.leaves((ro["m"], ro["v"])),
                    jax.tree.leaves((jopt["m"], jopt["v"]))):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
        assert np.all(np.isfinite(np.asarray(a)))


def test_train_cli_refuses_the_mesh_and_a_missing_card(monkeypatch,
                                                       tmp_path):
    for extra in (["--mesh", "2x2"], ["--fsdp"]):
        with pytest.raises(NotImplementedError, match="train mesh"):
            pt_train.main(["--arch", "deit-base-reduced", "--steps", "1",
                           "--device", "cpu", *extra])
    with pytest.raises(NotImplementedError, match="train mesh"):
        pt_train.train(pt_train.resolve_config("deit-base-reduced"),
                       steps=1, batch=2, seq=8, mesh_shape=(2, 2),
                       device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_train.main(["--arch", "deit-base-reduced", "--steps", "1"])
    # a fresh CPU run from the seed trains and saves (params, opt_state)
    # under the reference's key paths
    out = tmp_path / "fresh"
    _, opt, losses = pt_train.main(["--arch", "deit-base-reduced", "--steps",
                                    "2", "--batch", "4", "--device", "cpu",
                                    "--ckpt", str(out)])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert int(opt["step"]) == 2
    with np.load(out / "step_00000002" / "arrays.npz") as z:
        names = set(z.files)
    assert "1/step" in names and "0/cls" in names
    assert any(n.startswith("1/m/seg0/") for n in names)
    assert any(n.startswith("1/v/seg0/") for n in names)
