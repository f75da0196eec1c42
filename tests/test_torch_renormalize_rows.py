"""B10's renormalization in the port, on the CPU: `renormalize_rows`
(kernels/phased.py), which renormalizes several scorers' rows of one pod
at once, against `renormalize_plain` row by row and the JAX package's
`renormalize` (exactly: integers, tolerance 0) on BASELINE configs 1-5
and the default profile, with hook-edited raws and random feasibility;
then the engine's host path, which defers a pod's in-tree rows and
flushes them in one call: every BeforeScore / AfterScore /
AfterNormalize hook call, the bound pods and the annotations equal the
JAX engine's, and the flushes fall where the hooks need them (one a pod
without AfterNormalize hooks; one per hooked scorer, plus one for the
rest, with them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.framework import pipeline as jpipeline
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JCfg
from kube_scheduler_simulator_tpu.scheduler import debuggable as jdebuggable
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jcompile
from kube_scheduler_simulator_tpu_torch.framework import pipeline as ppipeline
from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry
from kube_scheduler_simulator_tpu_torch.kernels import phased as kphased
from kube_scheduler_simulator_tpu_torch.models import workloads as pworkloads
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.scheduler import debuggable as pdebuggable
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from test_torch_engine import JAX, PORT, assert_same, fill, snapshot
from test_torch_phased import _workload, _xs1

NORMALIZING = ppipeline.NORMALIZING


# ------------------------------------------------ the batched plain version

@pytest.mark.parametrize("wl", [f"config{i}" for i in range(1, 6)] + ["default_profile"])
def test_rows_plain_matches_per_row_and_jax(wl):
    """Per pod: renormalize_rows over the profile's scorers with
    ScoreExtensions at once, and over each alone, == renormalize_plain
    row by row == JAX renormalize, on raws a host hook edited; the other
    scorers' raws come back from pipeline.renormalize, as from JAX's;
    against random feasibility and against none (no node scored); the
    carry advanced by the binds of the pods before it."""
    nodes, pods, enabled, extra = _workload(wl)
    pcfg = PluginSetConfig(enabled=enabled) if enabled else PluginSetConfig()
    jcfg = JCfg(enabled=enabled) if enabled else JCfg()
    cw = compile_workload(nodes, pods, pcfg, device="cpu", **extra)
    jcw = jcompile(nodes, pods, jcfg, **extra)
    phased = ppipeline.build_phased(cw)
    eval_fn, bind_fn = jpipeline.build_phased(jcw)
    carry, jcarry = _clone_carry(cw.init_carry), jcw.init_carry
    names = list(cw.config.scorers())
    norm = [s for s, nm in enumerate(names) if nm in NORMALIZING]
    rng = np.random.default_rng(11)
    for i in range(min(cw.n_pods, 6)):
        xs1 = _xs1(cw, i)
        sl = jax.tree.map(lambda a: a[i] if hasattr(a, "ndim") and a.ndim else a, jcw.xs)
        jout = eval_fn(jcarry, sl)
        raws = np.asarray(jout.score_raw, dtype=np.int64)
        raws = raws + rng.integers(-5, 6, raws.shape) * (rng.random(raws.shape) < 0.3)
        codes_ok = np.asarray(jout.filter_codes).max(axis=0, initial=0) == 0
        for feas in (codes_ok & (rng.random(cw.n_nodes) < 0.8), np.zeros(cw.n_nodes, bool)):
            feas_t = torch.from_numpy(feas)
            got = (kphased.renormalize_rows(phased.step, [names[s] for s in norm], carry, xs1,
                                            torch.from_numpy(raws[norm]), feas_t)
                   if norm else None)
            for s, nm in enumerate(names):
                raw = torch.from_numpy(raws[s])
                want = np.asarray(jpipeline.renormalize(nm, jcw, jcarry, sl,
                                                        jnp.asarray(raws[s]),
                                                        jnp.asarray(feas)), dtype=np.int64)
                if s not in norm:
                    out = ppipeline.renormalize(nm, phased, carry, xs1, raw, feas_t)
                    np.testing.assert_array_equal(out.numpy(), want, err_msg=f"{wl} {i} {nm}")
                    continue
                row = ppipeline.renormalize_plain(nm, cw, carry, ppipeline.slice_pod(xs1, 0),
                                                  raw, feas_t)
                one = kphased.renormalize_rows(phased.step, [nm], carry, xs1, raw[None], feas_t)
                assert got.dtype == one.dtype == torch.int64
                assert torch.equal(got[norm.index(s)], row), (wl, i, nm)
                assert torch.equal(one[0], row), (wl, i, nm)
                np.testing.assert_array_equal(row.numpy(), want, err_msg=f"{wl} {i} {nm}")
        sel = int(np.asarray(jout.selected))
        if i % 3 != 2:
            carry = phased.bind(carry, xs1, sel)
            jcarry = bind_fn(jcarry, sl, np.int32(sel))


@pytest.mark.parametrize("names,rows,match", [
    (["NodeAffinity"], 2, "raws"),
    (["NodeAffinity", "NodeResourcesFit"], 2, "NodeResourcesFit"),
    ([], 0, "rows"),
])
def test_rows_refuse_what_they_cannot_normalize(names, rows, match):
    """One row a scorer, 1 to 16 rows, every scorer with ScoreExtensions:
    anything else raises, on the CPU as on the card."""
    nodes, pods, cfg = pworkloads.baseline_config(5, scale=0.01, seed=0)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    phased = ppipeline.build_phased(cw)
    raws = torch.zeros((rows, cw.n_nodes), dtype=torch.int64)
    with pytest.raises(ValueError, match=match):
        kphased.renormalize_rows(phased.step, names, cw.init_carry, _xs1(cw, 0), raws,
                                 torch.ones(cw.n_nodes, dtype=torch.bool))


@pytest.mark.parametrize("n,g", [(1, 1), (1536, 1), (1537, 2), (3072, 2), (3073, 4),
                                 (5000, 4), (6145, 8), (12288, 8), (12289, 16), (100_000, 16)])
def test_the_plan_takes_the_fewest_ctas_of_three_passes(n, g):
    """renorm_ctas: the smallest G whose slices a CTA of 512 threads
    covers in three passes, else 16."""
    assert kphased.renorm_ctas(n) == g


# ------------------------------------------------ the engine: hooks and flushes

def _log_hooks(mod, log, case):
    """Hooks that log each call (plugin, pod, and the node, score or the
    scores map it got) and edit what they may."""

    def who(pod):
        return (pod.get("metadata") or {}).get("name", "")

    class Scores(mod.PluginExtender):
        def __init__(self, plugin, shift):
            self.plugin, self.shift = plugin, shift

        def before_score(self, pod, node_name):
            log.append(("before_score", self.plugin, who(pod), node_name))
            if case == "cycle_error" and self.plugin == "InterPodAffinity" \
                    and who(pod).endswith(("3", "7")):
                return "refused"
            return None

        def after_score(self, pod, node_name, score):
            log.append(("after_score", self.plugin, who(pod), node_name, score))
            return 1000 - 3 * score if self.shift else score + (7 if node_name.endswith("2")
                                                                 else 0)

    class Normalized(Scores):
        def after_normalize(self, pod, scores):
            log.append(("after_normalize", self.plugin, who(pod), sorted(scores.items())))
            out = dict(scores)
            if out:
                out[sorted(out)[0]] = 10_000
            return out

    if case == "score_hooks":  # no AfterNormalize: one flush a pod
        return {"NodeAffinity": Scores("NodeAffinity", True),
                "PodTopologySpread": Scores("PodTopologySpread", False)}
    if case == "normalize_hooks":  # flushes at NodeAffinity, PodTopologySpread, the end
        return {"NodeAffinity": Normalized("NodeAffinity", True),
                "PodTopologySpread": Normalized("PodTopologySpread", False)}
    # cycle_error: InterPodAffinity, the last scorer of config 5 with
    # ScoreExtensions, refuses some pods while the others' rows wait
    return {"NodeAffinity": Scores("NodeAffinity", True),
            "InterPodAffinity": Scores("InterPodAffinity", False)}


def _run(pkg, mod, case, objects, cfg_kw, monkeypatch=None):
    log = []
    if monkeypatch is not None:
        orig_rows, orig_phase = kphased.renormalize_rows, SchedulerEngine._hooked_score_phase

        def rows(step, names, *a, **kw):
            log.append(("flush", tuple(names)))
            return orig_rows(step, names, *a, **kw)

        def phase(self, cw, phased, carry, xs1, pod, *a, **kw):
            log.append(("pod", (pod.get("metadata") or {}).get("name", "")))
            return orig_phase(self, cw, phased, carry, xs1, pod, *a, **kw)

        monkeypatch.setattr(kphased, "renormalize_rows", rows)
        monkeypatch.setattr(SchedulerEngine, "_hooked_score_phase", phase)
    store = fill(pkg, objects)
    engine = pkg.Engine(store, plugin_config=pkg.Cfg(**cfg_kw), **pkg.kw)
    engine.plugin_extenders = _log_hooks(mod, log, case)
    bound = engine.schedule_pending()
    engine.close()
    return bound, snapshot(store), log, engine


def _by_pod(log):
    pods, cur = [], None
    for e in log:
        if e[0] == "pod":
            cur = (e[1], [])
            pods.append(cur)
        else:
            cur[1].append(e)
    return pods


@pytest.mark.parametrize("case", ["score_hooks", "normalize_hooks", "cycle_error"])
def test_hook_order_and_flushes_match_jax(case, monkeypatch):
    """The port's engine (device="cpu") against the JAX engine with hooks
    on two scorers and one normalizing scorer unhooked: the same hook
    calls in the same order with the same arguments, the same bound pods
    and annotation bytes.  The port's flushes: each one's scorers in
    config order, every in-tree row of a pod in exactly one flush, a flush
    just before each AfterNormalize of an in-tree scorer, the last flush
    of a pod's rows otherwise at its end, so one flush a pod without
    AfterNormalize hooks and one per hooked scorer plus one for the rest
    with them; none after a BeforeScore cycle error; and the engine counts
    them."""
    nodes, pods, cfg = pworkloads.baseline_config(5, scale=0.01, seed=0)
    objects, cfg_kw = {"nodes": nodes, "pods": pods[:24]}, {"enabled": list(cfg.enabled)}
    launches = kphased.renormalize_rows.launches
    bound, snap, log, engine = _run(PORT, pdebuggable, case, objects, cfg_kw, monkeypatch)
    monkeypatch.undo()
    bound_ref, ref, jlog, _ = _run(JAX, jdebuggable, case, objects, cfg_kw)
    assert kphased.renormalize_rows.launches == launches  # the CPU runs the plain version
    hooks_only = [e for e in log if e[0] not in ("pod", "flush")]
    assert hooks_only == jlog and jlog
    assert bound == bound_ref and bound > 0
    assert_same(snap, ref)

    scorers = list(cfg.scorers())
    normalized = {"NodeAffinity", "PodTopologySpread"} if case == "normalize_hooks" else set()
    flushes = [e for e in log if e[0] == "flush"]
    assert len(flushes) == engine.renormalize_flushes > 0
    refused = 0
    for name, events in _by_pod(log):
        mine = [e[1] for e in events if e[0] == "flush"]
        rows = [nm for names in mine for nm in names]
        assert all(nm in NORMALIZING for nm in rows), rows
        assert rows == sorted(rows, key=scorers.index) and len(set(rows)) == len(rows)
        for j, e in enumerate(events):
            if e[0] == "after_normalize":  # its row, last of the flush just before it
                assert events[j - 1][0] == "flush" and events[j - 1][1][-1] == e[1], \
                    (name, events[:j + 1])
        if case == "cycle_error" and name.endswith(("3", "7")) and any(
                e[0] == "before_score" and e[1] == "InterPodAffinity" for e in events):
            refused += 1
            assert not mine, (name, mine)  # the waiting rows dropped unlaunched
            continue
        hooked = [nm for nm in rows if nm in normalized]
        rest = 1 if rows and rows[-1] not in normalized else 0
        assert len(mine) == len(hooked) + rest, (name, mine)
        if not normalized:
            assert len(mine) == (1 if rows else 0)
    assert refused > 0 or case != "cycle_error"
