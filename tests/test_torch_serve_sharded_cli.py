"""The port's serve CLI with ``--serve-sharded`` (after
tests/test_serve_sharded.py::test_serve_cli_sharded_end_to_end): a usage
error without ``--mesh-shape``, four spawned CPU ``gloo`` ranks end to end
with the per-device cache line, and the refusals, each before any rank
starts: a config whose slot cache does not split (JAX's
``shard_ineligible`` text), a MoE whose experts do not divide the model
axis, and the flags a sharded engine does not take; the enc-dec served
with ``--mem-len``; MLA (deepseek-v3) served with the unsharded CLI's
streams; and the shared-memory transport's collectives on messages past a
slot.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.serve import errors as jax_errors  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.mesh import launch  # noqa: E402
from torch_serve_dist import cli_ranks, host_collective_ranks  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
BASE = ["--trace", "6", "--slots", "2", "--max-len", "48",
        "--prompt-range", "4,10", "--gen-range", "2,6", "--device", "cpu",
        "--dist-backend", "gloo"]


def test_serve_sharded_without_mesh_shape_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        serve_cli.parse_args(["--arch", "deepseek-7b-reduced",
                              "--serve-sharded"])
    assert e.value.code == 2
    assert "--serve-sharded requires --mesh-shape" in capsys.readouterr().err


def test_serve_sharded_with_init_on_device_is_a_usage_error(capsys):
    """A sharded rank draws on the host and places only its blocks on its
    card; drawing the whole tree on the card is refused."""
    with pytest.raises(SystemExit) as e:
        serve_cli.parse_args(["--arch", "deepseek-7b-reduced",
                              "--serve-sharded", "--mesh-shape", "2x2",
                              "--init-on-device"])
    assert e.value.code == 2
    assert "drop --init-on-device" in capsys.readouterr().err


def test_serve_sharded_end_to_end_on_four_gloo_ranks():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "deepseek-7b-reduced", "--serve-sharded", "--mesh-shape", "2x2",
         *BASE], env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "sharded over {'data': 2, 'model': 2}: per-device cache" \
        in r.stdout, r.stdout
    assert re.search(r"\(4\.\d\dx smaller than unsharded\)", r.stdout)
    # CPU ranks reduce over their model group; four ranks' blocks
    line = re.search(r"\[serve\] per rank \(group collectives\): params "
                     r"\[(.*?)\] B, cache \[(.*?)\] B$", r.stdout, re.M)
    assert line, r.stdout
    for part in line.groups():
        assert len(set(part.split(", "))) == 1 and part.count(",") == 3
    row = [ln for ln in r.stdout.splitlines() if ln.startswith("| frontend")]
    assert len(row) == 1 and row[0].split("|")[3].strip() == "6"   # done


def test_one_kv_head_is_refused_with_jax_s_text():
    """qwen2-1.5b-reduced has one kv head: its K/V rows cannot split over
    two model ranks; refused before any rank starts."""
    with pytest.raises(ValueError) as e:
        serve_cli.main(["--arch", "qwen2-1.5b-reduced", "--serve-sharded",
                        "--mesh-shape", "2x2", *BASE])
    assert str(e.value) == jax_errors.msg(
        "shard_ineligible", name="qwen2-1.5b-reduced", leaf="k", m=2)


@pytest.mark.parametrize("arch,extra,layer", [
    ("deepseek-v3-671b-reduced", [], "MLA"),
])
def test_families_outside_the_slice_raise_by_name(tmp_path, arch, extra,
                                                   layer):
    """Once refused by name, MLA (with routed MoE) now serves sharded:
    the CLI's own rank body on four spawned ranks as 2x2 serves the trace
    with the streams of the unsharded CLI."""
    argv = ["--arch", arch, *BASE, *extra]
    want = {c.rid: [int(t) for t in c.tokens]
            for c in serve_cli.main(argv)["completions"]}
    out = tmp_path / "streams.json"
    launch(cli_ranks, 4, backend="gloo", device="cpu",
           init_method=f"file://{tmp_path}/rdzv",
           args=(argv + ["--serve-sharded", "--mesh-shape", "2x2"],
                 str(out)))
    got = {int(k): v for k, v in json.loads(out.read_text()).items()}
    assert len(want) == 6 and got == want, layer


def test_mamba_hybrid_raises_by_name_and_only_for_mamba():
    """``check_forward_split`` passes the Mamba hybrid and MLA at full
    width (jamba-1.5-large-398b, deepseek-v3-671b, at their expert counts'
    divisors) and still refuses a MoE whose experts do not divide the
    model axis; jamba's reduced config is still refused, as
    ``shard_ineligible``, for its one kv head."""
    from repro_torch.configs import resolve_config
    from repro_torch.distrib.sharding import check_forward_split
    for arch in ("jamba-1.5-large-398b", "deepseek-v3-671b"):
        for m in (2, 4, 8):
            check_forward_split(resolve_config(arch), m)
    with pytest.raises(ValueError, match="do not split"):
        check_forward_split(resolve_config(
            "qwen3-moe-235b-a22b-reduced"), 8)
    with pytest.raises(ValueError) as e:
        serve_cli.main(["--arch", "jamba-1.5-large-398b-reduced",
                        "--serve-sharded", "--mesh-shape", "2x2", *BASE])
    assert str(e.value) == jax_errors.msg(
        "shard_ineligible", name="jamba-1.5-large-398b-reduced", leaf="k",
        m=2)


def test_serve_sharded_seamless_on_four_gloo_ranks():
    """The enc-dec at 2x2 with ``--mem-len``: each request's frames go
    with its prefill to the ranks that hold its slot."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "seamless-m4t-large-v2-reduced", "--mem-len", "8",
         "--serve-sharded", "--mesh-shape", "2x2", *BASE], env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert re.search(r"\[serve\] per rank \(group collectives\): params "
                     r"\[.*\] B, cache \[.*\] B$", r.stdout, re.M), r.stdout
    row = [ln for ln in r.stdout.splitlines() if ln.startswith("| frontend")]
    assert len(row) == 1 and row[0].split("|")[3].strip() == "6"   # done


@pytest.mark.parametrize("flags", [["--prefix-cache", "4"],
                                   ["--replicas", "2"]])
def test_prefix_cache_and_replicas_are_refused_by_name(flags):
    flag = flags[0]
    with pytest.raises(NotImplementedError, match=re.escape(flag)):
        serve_cli.main(["--arch", "deepseek-7b-reduced", "--serve-sharded",
                        "--mesh-shape", "2x2", *BASE, *flags])


def test_host_transport_collectives_past_a_slot(tmp_path):
    """The shared-memory collectives (those of ranks that share a card) of
    four spawned ranks, each model group of a 2 x 2 mesh apart: a sum of 12 MB
    (three slot-sized chunks) and gathers of bf16, fp64 and fp32 blocks
    equal what the group's ranks sent."""
    launch(host_collective_ranks, 4, backend="gloo", device="cpu",
           init_method=f"file://{tmp_path}/rdzv", args=(str(tmp_path),))
    for r in range(4):
        rec = json.loads((tmp_path / f"host_rank{r}.json").read_text())
        assert rec == {"reduce_exact": True, "gather_exact": True,
                       "calls": 4}, (r, rec)
