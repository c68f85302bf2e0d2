"""The port's CORP on deepseek-v3-671b against the JAX package, continued
from ``test_torch_deepseek_prune.py`` (its setup, helpers and tolerances):
whole-expert removal beside the shared expert, streamed CORP, checkpoints
in both directions and serving the pruned model through the CLIs. Split
from that file so that two workers share them.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import ServeEngine as JaxServe  # noqa: E402
from repro.serve import synthetic_trace as jax_trace  # noqa: E402
from repro_torch.core import PruneConfig  # noqa: E402
from repro_torch.core import corp_prune, corp_prune_streamed  # noqa: E402
from repro_torch.launch import prune as pt_prune  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from test_torch_deepseek_prune import (ARCH, MOE, SERVE, _check_j,  # noqa: E402,F401
                                       _gathered_equal, _jax_prune,
                                       _port_logits, s)
from torch_parity import lm_logits, rel, to_port_cfg  # noqa: E402


@pytest.mark.parametrize("compensate", [True, False])
def test_expert_sparsity_matches_jax(s, compensate):
    """``expert_sparsity`` 0.5 beside the shared expert: the same kept
    experts (router columns) as JAX, the shared expert pruned as well."""
    jp, jcfg, jrep, want = _jax_prune(s, experts=0.5, compensate=compensate)
    pp, pcfg, rep = corp_prune(
        s["pt_model"], s["pt_params"], s["pt_calib"],
        PruneConfig(0.5, 0.5, expert_sparsity=0.5, compensate=compensate))
    assert pcfg == to_port_cfg(jcfg) and pcfg.eff_num_experts == 2
    assert rep["plan_sizes"][MOE + "/experts"] == (2, 2)
    mlp, jmlp = pp["seg1"]["p0"]["mlp"], jp["seg1"]["p0"]["mlp"]
    np.testing.assert_array_equal(mlp["router"].numpy(),
                                  np.asarray(jmlp["router"]))
    assert ("moe_resid" in mlp) == compensate
    assert tuple(mlp["shared"]["wd"].shape) == (2, 64, 64)
    if compensate:
        _check_j(rep)
    _gathered_equal(pp, jp)
    assert rel(_port_logits(s, pp, pcfg), want) <= 1e-4


def test_streamed_matches_jax_and_the_one_shot_prune(s):
    """Two units a group: (l0 mla, l0 mlp), (p0 mla, p0 moe), (p0 shared);
    the shared expert folds into the MoE block that an earlier group
    folded."""
    _, _, jrep, want = _jax_prune(s, group=2)
    pc = PruneConfig(0.5, 0.5)
    pp, pcfg, rep = corp_prune_streamed(s["pt_model"], s["pt_params"],
                                        s["pt_calib"], pc, unit_group_size=2)
    assert rep["groups"] == jrep["groups"] == 3
    assert rep["traversals"] == jrep["traversals"] == 5
    got = _port_logits(s, pp, pcfg)
    assert rel(got, want) <= 1e-4
    one = corp_prune(s["pt_model"], s["pt_params"], s["pt_calib"], pc)
    assert rel(got, _port_logits(s, one[0], one[1])) <= 1e-4


# ---------------------------------------------------------------------------
# checkpoints and the CLIs
# ---------------------------------------------------------------------------

_CLI = ["--arch", ARCH + "-reduced", "--calib", "16", "--calib-batch", "8",
        "--calib-seq", "16", "--device", "cpu"]


def test_cli_checkpoint_drops_the_shared_bd_in_jax_not_in_the_port(
        s, tmp_path):
    """Reference fault 2 extended to the shared expert: the prune CLI
    writes ``mlp/shared/bd`` (and the dense layer's ``mlp/bd`` and
    ``bd_moe``); JAX's pruned template has none of them, so its restore
    drops them and its model computes other logits. Given a template
    that holds them, JAX's model computes the port's; the port's serve CLI
    restores them."""
    out = str(tmp_path)
    res = pt_prune.main(_CLI + ["--sparsity", "0.5", "--out", out])
    pcfg = res["pruned_cfg"]
    pm = res["pruned_params"]
    want = _port_logits(s, pm, pcfg)
    jcfg = s["jcfg"].pruned(0.5, 0.5)
    jtmpl = jax_build(jcfg).init(jax.random.PRNGKey(0))
    dropped, _ = jax_restore(out, 0, jtmpl)
    assert "bd" not in dropped["seg1"]["p0"]["mlp"]["shared"]
    assert rel(lm_logits(jax_build(jcfg), dropped, s["jax_held"]),
               want) > 1e-3
    leaves = {("seg0", "l0", "bd"), ("seg1", "p0", "bd_moe"),
              ("seg1", "p0", "shared/bd")}
    for seg, lk, k in leaves:
        tgt = jtmpl[seg][lk]["mlp"]
        src = pm[seg][lk]["mlp"]
        if k.startswith("shared/"):
            tgt, src, k = tgt["shared"], src["shared"], "bd"
        tgt[k] = jnp.zeros(tuple(src[k].shape))
    full, _ = jax_restore(out, 0, jtmpl)
    got = lm_logits(jax_build(jcfg), full, s["jax_held"])
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    served = pt_serve.main(["--arch", ARCH + "-reduced", "--sparsity", "0.5",
                            "--ckpt-in", out] + SERVE)
    assert torch.equal(served["params"]["seg1"]["p0"]["mlp"]["shared"]["bd"],
                       pm["seg1"]["p0"]["mlp"]["shared"]["bd"])
    assert bool(pm["seg1"]["p0"]["mlp"]["shared"]["bd"].any())


def test_no_compensate_checkpoint_serves_the_shared_bd_as_zeros(tmp_path):
    """A ``--no-compensate`` checkpoint has no ``mlp/shared/bd``; the
    serve CLI restores it as zeros (``COMPENSATION_LEAVES``)."""
    out = str(tmp_path)
    pt_prune.main(_CLI + ["--sparsity", "0.5", "--no-compensate", "--out",
                          out])
    assert "mlp/shared/bd" in pt_serve.COMPENSATION_LEAVES
    served = pt_serve.main(["--arch", ARCH + "-reduced", "--sparsity", "0.5",
                            "--ckpt-in", out] + SERVE)
    assert not served["params"]["seg1"]["p0"]["mlp"]["shared"]["bd"].any()
    assert len(served["completions"]) == 4


@pytest.mark.parametrize("case", ["dense", "pruned", "experts"])
def test_serve_cli_streams_equal_the_jax_engine(s, tmp_path, case):
    """``launch.serve --ckpt-in`` of a JAX-written checkpoint (dense, JAX's
    0.5/0.5 prune, and with experts removed too): the streams equal the
    JAX engine's on the same params."""
    flags, kw = [], {}
    if case == "dense":
        jp, jcfg = s["jax_params"], s["jcfg"]
    else:
        kw = {"experts": 0.5} if case == "experts" else {}
        jp, jcfg = _jax_prune(s, **kw)[:2]
        flags = ["--sparsity", "0.5"] + (
            ["--expert-sparsity", "0.5"] if kw else [])
    jax_save(str(tmp_path), 0, jax.tree.map(np.asarray, jp),
             extra={"config": jcfg.name})
    served = pt_serve.main(["--arch", ARCH + "-reduced", "--ckpt-in",
                            str(tmp_path)] + flags + SERVE)
    jeng = JaxServe(jax_build(jcfg), jax.tree.map(jnp.asarray, jp),
                    n_slots=2, max_len=40)
    want = jeng.run(jax_trace(4, jcfg.vocab_size, seed=0,
                              prompt_range=(6, 16), gen_range=(3, 8)))
    assert [c.tokens.tolist() for c in served["completions"]] == \
        [c.tokens.tolist() for c in want]


def test_prune_cli_one_traversal_and_expert_sparsity(tmp_path):
    """``launch.prune`` on the CPU with ``--one-traversal`` (a class-1
    hit at margin 1.0: one traversal) and ``--expert-sparsity 0.5``."""
    res = pt_prune.main(_CLI + ["--sparsity", "0.5", "--one-traversal",
                                "--spec-margin", "1.0"])
    assert res["report"]["traversals"] == 1
    assert not res["report"]["speculative"]["misses"]
    res = pt_prune.main(_CLI + ["--sparsity", "0.5", "--expert-sparsity",
                                "0.5", "--out", str(tmp_path)])
    pcfg = res["pruned_cfg"]
    assert (pcfg.eff_num_experts, pcfg.eff_qk) == (2, 8)
    served = pt_serve.main(["--arch", ARCH + "-reduced", "--sparsity", "0.5",
                            "--expert-sparsity", "0.5", "--ckpt-in",
                            str(tmp_path)] + SERVE)
    assert len(served["completions"]) == 4
