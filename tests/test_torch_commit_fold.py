"""B5's core commit folded into the oracle launch (csrc/oracle.cu), on
the CPU.

* The C struct the launch takes (`OracleCommit`) against its ctypes twin
  in kernels/spec.py, compiled with g++.
* The fold decision (parallel/speculative.py `commit_folds`): a
  core-only carry, no interaction rule, no gang.
* The folded oracle's plain form (`oracle_commit_plain`: the plain
  oracle, then `commit_plain` at k = min(K, m), in place) against the
  JAX package's `_oracle_core` then `_commit_fn` on the same seeded
  batches and carries, at b = 8, 32 and 512: accepted prefixes, early
  conflicts, all pad rows and m = 0; and a sparse round past its
  candidate cap, which commits nothing.
* Streams whose rounds fold (the slot-pinned fleet's sparse rounds, a
  fleet whose rounds run dense after a wide sparse round, a contended
  dense fleet) against the JAX package's streams, exactly: every round's
  commit is its oracle's and `spec_commit` is never called; a
  label-coupled stream (the interaction rule) folds none.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kube_scheduler_simulator_tpu.framework.replay import _workload_scan_key
from kube_scheduler_simulator_tpu.models import workloads as jwl
from kube_scheduler_simulator_tpu.parallel import speculative as jspec
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JPluginSetConfig
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry
from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
from kube_scheduler_simulator_tpu_torch.models import workloads as pwl
from kube_scheduler_simulator_tpu_torch.parallel import speculative as pspec
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from test_torch_speculative import (SAFE, _contention, _mixed, _np, _slots, assert_same,
                                    assert_same_carry, both_inputs, env)

CSRC = Path(kspec.__file__).resolve().parent.parent / "csrc"


def test_oracle_commit_struct_layout(tmp_path):
    """csrc/oracle.cu's OracleCommit compiled with g++: its size and
    every field's offset equal kernels/spec.py's ctypes twin."""
    text = (CSRC / "oracle.cu").read_text()
    struct = re.search(r"^struct OracleCommit \{.*?^\};", text, re.M | re.S).group(0)
    fields = [f for f, _t in kspec.OracleCommit._fields_]
    src = tmp_path / "layout.cpp"
    src.write_text(
        "#include <cstddef>\n#include <cstdio>\n" + struct + "\n"
        "int main() {\n  printf(\"%zu\\n\", sizeof(OracleCommit));\n"
        + "".join(f'  printf("%zu\\n", offsetof(OracleCommit, {f}));\n' for f in fields)
        + "}\n")
    exe = tmp_path / "layout"
    subprocess.run(["g++", "-std=c++17", str(src), "-o", str(exe)], check=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout.split()
    assert int(out[0]) == ctypes.sizeof(kspec.OracleCommit)
    for f, off in zip(fields, out[1:]):
        assert int(off) == getattr(kspec.OracleCommit, f).offset, f


@pytest.mark.parametrize("carry,inter,gang,folds", [
    (("core",), None, None, True),
    (("core", "NodePorts"), None, None, False),
    (("core", "PodTopologySpread"), None, None, False),
    (("core",), object(), None, False),
    (("core",), None, object(), False),
    (("core", "InterPodAffinity"), object(), object(), False),
], ids=["core_only", "ports", "spread", "interaction_rule", "gang", "none_holds"])
def test_commit_folds_decision(carry, inter, gang, folds):
    assert pspec.commit_folds(dict.fromkeys(carry), inter, gang) is folds


# (lo, b, kind): a batch of the mixed fleet (36 pods) from `lo`, pad rows
# past the queue; "eval" takes the eval's own selections, the others an
# oracle_batch of that kind over the same pods
FOLD_CASES = [(0, 8, "eval"), (24, 8, "eval"), (0, 32, "eval"), (20, 32, "eval"),
              (0, 8, "first"), (0, 32, "accepted"), (0, 512, "eval"), (0, 512, "last"),
              (0, 512, "random")]


def _jax_commit(jcw, jcarry, jxs, selected, k: int, b: int):
    fn = jspec._commit_fn(jcw, _workload_scan_key(jcw, b), b)
    return fn(jax.tree.map(jnp.array, jcarry), jxs, jnp.asarray(_np(selected)),
              jnp.arange(b) < k)


@pytest.mark.parametrize("lo,b,kind", FOLD_CASES)
def test_folded_oracle_plain_matches_jax(lo, b, kind):
    """K and the committed carry equal the JAX oracle then the JAX core
    commit of the rows below min(K, m)."""
    step, carry, xs, jcw, jcarry, jxs, (pack_mode, _) = both_inputs("mixed", lo, b, seed=lo + b)
    assert kspec.core_only(carry)
    m = int((~xs["is_pad"]).sum())
    if kind == "eval":
        out = kspec.eval_plain(step, carry, xs)
        packed, reject, sel = out.packed_filter, out.prefilter_reject, out.selected
    else:
        packed, reject, sel = chip_smoke.oracle_batch(kind, b, step.cw.n_nodes,
                                                      out_dtype(pack_mode), seed=b, pads=b - m)
    mine = _clone_carry(carry)
    k = kspec.oracle_commit_plain(packed, reject, sel, kspec.Commit(mine, xs, m))
    jk = jspec._oracle_core(jnp.asarray(_np(packed)), jnp.asarray(_np(reject)),
                            jnp.asarray(_np(sel)), b)
    assert int(k) == int(jk)
    assert_same_carry(mine, _jax_commit(jcw, jcarry, jxs, sel, min(int(k), m), b))
    # the plain form is the plain oracle then commit_plain at that k
    want = kspec.commit_plain(step, _clone_carry(carry), xs, sel, min(int(k), m))
    for a, w in zip(mine["core"], want["core"]):
        assert torch.equal(a, w)


def out_dtype(pack_mode):
    from kube_scheduler_simulator_tpu_torch.framework.pipeline import PACK_MODES

    return PACK_MODES[pack_mode][0]


@pytest.mark.parametrize("b", [8, 32, 512])
@pytest.mark.parametrize("case", ["all_pad", "m_zero"])
def test_folded_oracle_commits_nothing_without_rows(b, case):
    """Every row a pad row (selected -1), or m = 0 with real selections:
    K as the oracle's, the carry untouched."""
    step, carry, xs, *_ = both_inputs("mixed", 0, b, seed=b)
    packed, reject, sel = chip_smoke.oracle_batch("accepted", b, step.cw.n_nodes,
                                                  torch.uint8, seed=b,
                                                  pads=b if case == "all_pad" else 0)
    mine = _clone_carry(carry)
    k = kspec.oracle_commit_plain(packed, reject, sel, kspec.Commit(mine, xs, 0))
    assert int(k) == int(kspec._oracle_core(packed, reject, sel, b))
    for a, w in zip(mine["core"], carry["core"]):
        assert torch.equal(a, w)


@pytest.mark.parametrize("kcand,wide", [(1, True), (10_000, False)])
def test_sparse_commit_past_the_cap_commits_nothing(kcand, wide):
    """A sparse round's commit with a row b < m feasible at more nodes
    than the cap commits nothing (the host runs the round dense); within
    the cap it commits as the dense form does."""
    step, carry, xs, *_ = both_inputs("mixed", 0, 8, seed=5)
    r = kspec.sparse_round_plain(step, carry, xs, step.cw.n_nodes)
    m = 8
    commit = kspec.Commit(_clone_carry(carry), xs, m)
    member = kfuse.Member(step, carry, xs, kcand, m)
    got = kfuse.sparse_commit(member, r)
    assert got.counts is r[2] and got.kcand == kcand
    assert kspec.commit_wide(got._replace(carry=commit.carry)) is wide
    k = kspec.oracle_commit_plain(r[0], r[1], r[7], got._replace(carry=commit.carry))
    want = (carry if wide else
            kspec.commit_plain(step, _clone_carry(carry), xs, r[7], min(int(k), m)))
    for a, w in zip(commit.carry["core"], want["core"]):
        assert torch.equal(a, w)


# ------------------------------------------------------------ streams

STREAMS = {
    # (workload, stream kwargs, env knobs, folds)
    "slots_sparse": (_slots, dict(chunk=64), {}, True),
    "mixed_wide_dense": (_mixed, dict(chunk=8), {"KSS_TPU_SPECULATIVE_CANDIDATES": 4}, True),
    "contention_dense": (_contention, dict(chunk=8), {}, True),
    "coupled_interaction": (
        lambda m: (m.make_nodes(16, seed=5), m.make_pods(40, seed=6, with_spread=True),
                   SAFE + ["PodTopologySpread"]), dict(chunk=16), {}, False),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_with_the_fold_matches_jax(name, monkeypatch):
    build, rkw, knobs, folds = STREAMS[name]
    nodes, pods, enabled = build(pwl)
    jnodes, jpods, _ = build(jwl)
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=enabled), device="cpu")
    jcw = jax_compile(jnodes, jpods, JPluginSetConfig(enabled=enabled))
    calls = {"spec_commit": 0, "folded": 0, "oracles": 0}
    real_commit, real_plain = kspec.spec_commit, kspec.oracle_commit_plain

    def spy_commit(*a, **kw):
        calls["spec_commit"] += 1
        return real_commit(*a, **kw)

    def spy_plain(packed, reject, sel, commit):
        calls["oracles"] += 1
        calls["folded"] += commit is not None and not kspec.commit_wide(commit)
        return real_plain(packed, reject, sel, commit)

    monkeypatch.setattr(kspec, "spec_commit", spy_commit)
    monkeypatch.setattr(kspec, "oracle_commit_plain", spy_plain)
    coupled = bool(set(enabled) & pspec.LABEL_COUPLED)
    with env(**knobs, KSS_TPU_HOST_RESIDENT=1, KSS_TPU_FUSE="0"):
        rr, stats = pspec.replay_speculative_stream(cw, pods=pods if coupled else None, **rkw)
        jrr, jstats = jspec.replay_speculative_stream(jcw, pods=jpods if coupled else None,
                                                      **rkw)
    assert_same(rr.selected, jrr.selected, "selected")
    assert_same(rr.feasible_count, jrr.feasible_count, "feasible_count")
    assert stats == jstats
    rounds = stats["rounds"]
    assert rounds > 0 and calls["oracles"] >= rounds
    if folds:
        assert calls["spec_commit"] == 0 and calls["folded"] == rounds, calls
    else:
        assert calls["folded"] == 0 and calls["spec_commit"] == rounds, calls
