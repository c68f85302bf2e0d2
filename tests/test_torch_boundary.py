"""The port's boundary: what it may import, its copied configs, its device
rule, and a checkpoint that the JAX package loads."""
from __future__ import annotations

import ast
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.checkpoint import restore_checkpoint  # noqa: E402
from repro.data import calib_stream as jax_calib_stream  # noqa: E402
from repro.data.synthetic import vit_batch as jax_vit_batch  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import configs as pt_configs  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.data import calib_stream, vit_batch  # noqa: E402
from repro_torch.launch import prune as pt_prune  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import build_model as pt_build  # noqa: E402
from torch_parity import images, to_port_cfg  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _port_files():
    pkg = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, names in os.walk(pkg):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = list(_port_files())
    assert len(files) > 20 and os.path.exists(files[-1])
    for path in files:
        roots = set(_imported_roots(path))
        bad = roots & {"jax", "jaxlib", "repro"}
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


@pytest.mark.parametrize("arch", jax_configs.DEIT_IDS + pt_configs.LM_IDS
                         + pt_configs.ENCDEC_IDS)
def test_copied_configs_equal_jax_configs(arch):
    want = jax_configs.get_config(arch)
    got = pt_configs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(pt_configs.reduced(got)) \
        == dataclasses.asdict(jax_configs.reduced(want))
    for s in (0.25, 0.5):
        for a, b in ((got.pruned(s, s), want.pruned(s, s)),
                     (got.pruned(s, s, round_to=8),
                      want.pruned(s, s, round_to=8)),
                     (got.pruned(s, s, expert_sparsity=s),
                      want.pruned(s, s, expert_sparsity=s))):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert (a.eff_qk, a.eff_d_ff, a.qk_full) \
                == (b.eff_qk, b.eff_d_ff, b.qk_full)
            if b.moe is not None:
                assert (a.eff_num_experts, a.eff_d_expert) \
                    == (b.eff_num_experts, b.eff_d_expert)
    for a, b in ((got, want), (pt_configs.reduced(got),
                               jax_configs.reduced(want))):
        assert (a.padded_vocab, a.layout()) == (b.padded_vocab, b.layout())


def test_synthetic_batches_are_bit_identical_to_jax():
    kw = dict(batch=4, img=32, n_classes=10, seed=3)
    want = jax_vit_batch(5, **kw)
    got = vit_batch(5, device="cpu", **kw)
    for k in ("images", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    cfg = pt_configs.resolve_config("deit-base-reduced")
    jcfg = jax_configs.reduced(jax_configs.get_config("deit-base"))
    a = list(calib_stream(cfg, n_samples=8, batch=4, device="cpu")())
    b = list(jax_calib_stream(jcfg, n_samples=8, batch=4)())
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["images"].numpy(),
                                      np.asarray(y["images"]))


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        pt_prune.main(["--arch", "deit-base-reduced"])
    with pytest.raises(RuntimeError):
        pt_serve.main(["--arch", "qwen2-1.5b-reduced", "--trace", "2"])
    assert resolve_device("cpu").type == "cpu"


def test_unported_paths_raise():
    """Every model of the JAX package is ported: the enc-dec
    ``seamless-m4t-large-v2`` resolves in both packages, full and
    reduced, to equal configs (as deepseek-v3-671b and
    jamba-1.5-large-398b do); mesh-sharded calibration still refuses by
    name."""
    arch = "seamless-m4t-large-v2"
    for name in (arch, arch + "-reduced"):
        got = pt_configs.resolve_config(name)
        want = jax_configs.get_config(arch)
        if name.endswith("-reduced"):
            want = jax_configs.reduced(want)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(pt_configs.reduced(to_port_cfg(
        jax_configs.get_config(arch)))) == dataclasses.asdict(
        jax_configs.reduced(jax_configs.get_config(arch)))
    assert set(jax_configs.ARCH_IDS) \
        == set(pt_configs.LM_IDS + pt_configs.ENCDEC_IDS)
    with pytest.raises(NotImplementedError, match="--mesh"):
        pt_prune.main(["--arch", "deit-base-reduced", "--device", "cpu",
                       "--mesh", "2x2"])


def test_cli_checkpoint_restores_into_jax(tmp_path):
    out = str(tmp_path / "pruned")
    res = pt_prune.main(["--arch", "deit-base-reduced", "--sparsity", "0.5",
                         "--calib", "16", "--calib-batch", "8",
                         "--device", "cpu", "--out", out])
    pcfg = res["pruned_cfg"]
    jcfg = jax_configs.reduced(jax_configs.get_config("deit-base")) \
        .pruned(0.5, 0.5)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    jmodel = jax_build(jcfg)
    like = jmodel.init(jax.random.PRNGKey(0))
    restored, extra = restore_checkpoint(out, 0, like)
    assert extra["config"] == jcfg.name
    assert os.path.exists(os.path.join(out, "report.json"))
    x = images(jcfg, B=4, seed=5)
    want = np.asarray(jmodel.apply(restored, {"images": jnp.asarray(x)}))
    got = pt_build(pcfg).apply(res["pruned_params"],
                               {"images": torch.from_numpy(x)}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
