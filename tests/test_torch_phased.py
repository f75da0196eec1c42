"""Kernel B10 in the port, on the CPU: the host-interleaved path's phased
step (framework/pipeline.py `Phased`, `renormalize`) against the JAX
package's `build_phased` / `renormalize`, exactly (integers, tolerance
0), per pod of BASELINE configs 1-5 and the default profile, on carries
advanced by the binds of the pods before it; then the engine's host
path against the JAX engine's: webhook extenders over HTTP (filter,
prioritize, bind, preempt — after tests/test_extender.py) and
plugin-extender hooks on in-tree plugins, AfterScore among them, which
forces `renormalize` (after tests/test_plugin_extender_hooks.py).
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kube_scheduler_simulator_tpu.framework import pipeline as jpipeline
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JCfg
from kube_scheduler_simulator_tpu.scheduler import debuggable as jdebuggable
from kube_scheduler_simulator_tpu.scheduler import extender as jextender
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jcompile
from kube_scheduler_simulator_tpu_torch.framework import pipeline as ppipeline
from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _slice_xs
from kube_scheduler_simulator_tpu_torch.kernels import phased as kphased
from kube_scheduler_simulator_tpu_torch.models import workloads as pworkloads
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.scheduler import debuggable as pdebuggable
from kube_scheduler_simulator_tpu_torch.scheduler import extender as pextender
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import annotations as ann
from test_torch_engine import JAX, PORT, assert_same, fill, snapshot


# ------------------------------------------------ B10's plain versions

def _workload(name):
    if name == "default_profile":
        nodes, pods, _ = pworkloads.baseline_config(5, scale=0.006, seed=3)
        volumes, bound = chip_smoke.decorate_default_profile(nodes, pods, seed=3)
        return nodes, pods, None, dict(volumes=volumes, bound_pods=bound)
    idx = int(name[-1])
    nodes, pods, cfg = pworkloads.baseline_config(idx, scale=0.01, seed=0)
    return nodes, pods, list(cfg.enabled), {}


def _xs1(cw, i):
    xs1 = _slice_xs(cw.xs, i, i + 1, 1)
    xs1["is_pad"] = torch.zeros(1, dtype=torch.bool)
    return xs1


@pytest.mark.parametrize("wl", [f"config{i}" for i in range(1, 6)] + ["default_profile"])
def test_phased_plain_matches_jax(wl):
    """Per pod: the port's Phased.plain_eval == JAX eval_fn (every
    StepOut field at every node), renormalize_plain == JAX renormalize for
    every scorer on raws and feasibility a host hook edited, and the
    carry advanced by Phased.bind == JAX bind_fn (the next pod's eval
    reads it)."""
    nodes, pods, enabled, extra = _workload(wl)
    pcfg = PluginSetConfig(enabled=enabled) if enabled else PluginSetConfig()
    jcfg = JCfg(enabled=enabled) if enabled else JCfg()
    cw = compile_workload(nodes, pods, pcfg, device="cpu", **extra)
    jcw = jcompile(nodes, pods, jcfg, **extra)
    phased = ppipeline.build_phased(cw)
    eval_fn, bind_fn = jpipeline.build_phased(jcw)
    carry, jcarry = _clone_carry(cw.init_carry), jcw.init_carry
    rng = np.random.default_rng(7)
    n_pods = min(cw.n_pods, 12)
    for i in range(n_pods):
        xs1 = _xs1(cw, i)
        sl = jax.tree.map(lambda a: a[i] if hasattr(a, "ndim") and a.ndim else a, jcw.xs)
        out = phased.plain_eval(carry, xs1)
        jout = eval_fn(jcarry, sl)
        for f in out._fields:
            np.testing.assert_array_equal(getattr(out, f).numpy(),
                                          np.asarray(getattr(jout, f)), err_msg=f"{wl} {i} {f}")
        assert out.selected.dtype == torch.int32 and out.score_raw.dtype == torch.int32
        # a host hook's edit: AfterScore shifts some raws, a filter drops nodes
        feas = np.asarray(jout.filter_codes).max(axis=0, initial=0) == 0
        feas &= rng.random(feas.shape[0]) < 0.8
        for s, name in enumerate(cw.config.scorers()):
            raw = np.asarray(jout.score_raw[s], dtype=np.int64)
            raw = raw + rng.integers(-3, 4, raw.shape[0]) * (rng.random(raw.shape[0]) < 0.3)
            want = np.asarray(jpipeline.renormalize(name, jcw, jcarry, sl, jnp.asarray(raw),
                                                    jnp.asarray(feas)), dtype=np.int64)
            got = ppipeline.renormalize(name, phased, carry, xs1, torch.from_numpy(raw),
                                        torch.from_numpy(feas))
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{wl} {i} {name}")
        sel = int(out.selected)
        if i % 3 != 2:  # bind most pods, skip some: the carry advances unevenly
            carry = phased.bind(carry, xs1, sel)
            jcarry = bind_fn(jcarry, sl, np.int32(sel))


def test_renormalize_without_score_extensions_returns_raws():
    nodes, pods, cfg = pworkloads.baseline_config(5, scale=0.01, seed=0)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    phased = ppipeline.build_phased(cw)
    raw = torch.arange(cw.n_nodes, dtype=torch.int64) - 3
    feas = torch.ones(cw.n_nodes, dtype=torch.bool)
    launches = kphased.renormalize_row.launches
    for name in ("NodeResourcesFit", "NodeResourcesBalancedAllocation"):
        out = ppipeline.renormalize(name, phased, cw.init_carry, _xs1(cw, 0), raw, feas)
        assert torch.equal(out, raw)
    assert kphased.renormalize_row.launches == launches


# ------------------------------------------------ the engine's host path

class FakeExtender(BaseHTTPRequestHandler):
    """Vetoes node index 0, boosts the last node, binds, and keeps the
    last preemption candidate (tests/test_extender.py)."""

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        names = body.get("NodeNames") or []
        if self.path.endswith("/filter"):
            resp = {"NodeNames": [n for n in names if not n.endswith("00000")],
                    "FailedNodes": {n: "vetoed by extender"
                                    for n in names if n.endswith("00000")}}
        elif self.path.endswith("/prioritize"):
            resp = [{"Host": n, "Score": 10 if n == names[-1] else 0} for n in names]
        elif self.path.endswith("/preempt"):
            victims = body.get("NodeNameToVictims") or {}
            keep = max(victims) if victims else None
            resp = {"nodeNameToMetaVictims": {keep: {"pods": [
                {"uid": (v.get("metadata") or {}).get("uid", "")}
                for v in victims[keep].get("Pods") or []]}} if keep else {}}
        else:
            resp = {}
        data = json.dumps(resp).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture()
def fake_extender():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), FakeExtender)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()


def _with_extenders(pkg, ext_mod, objects, cfg_kw, ext_cfgs):
    store = fill(pkg, objects)
    cfg = pkg.Cfg(**cfg_kw)
    engine = pkg.Engine(store, plugin_config=cfg, **pkg.kw)
    engine.set_extenders(ext_mod.ExtenderService(ext_cfgs))
    bound = engine.schedule_pending()
    engine.close()
    return bound, snapshot(store)


def _capacity_node(name):
    return {"metadata": {"name": name},
            "status": {"allocatable": {"cpu": "2", "memory": "4Gi", "pods": "10"}}}


def _prio_pod(name, prio, cpu="2", node=None):
    spec = {"priority": prio, "containers": [
        {"name": "c", "resources": {"requests": {"cpu": cpu, "memory": "1Gi"}}}]}
    if node:
        spec["nodeName"] = node
    return {"kind": "Pod", "metadata": {"name": name, "uid": f"uid-{name}"}, "spec": spec}


def _extender_cases(url):
    nodes, pods, cfg = pworkloads.baseline_config(5, scale=0.01, seed=0)
    six = {"enabled": list(cfg.enabled)}
    return {
        "filter_prioritize": ({"nodes": nodes, "pods": pods[:24]}, six,
                              [{"urlPrefix": url, "filterVerb": "filter",
                                "prioritizeVerb": "prioritize", "weight": 2}]),
        "bind": ({"nodes": pworkloads.make_nodes(3, seed=21),
                  "pods": pworkloads.make_pods(4, seed=22)}, {},
                 [{"urlPrefix": url, "bindVerb": "bind", "filterVerb": "filter",
                   "weight": 1}]),
        "preempt": ({"nodes": [_capacity_node("node-a"), _capacity_node("node-b")],
                     "pods": [_prio_pod("victim-node-a", 0, node="node-a"),
                              _prio_pod("victim-node-b", 0, node="node-b"),
                              _prio_pod("urgent", 100)]}, {},
                    [{"urlPrefix": url, "preemptVerb": "preempt"}]),
        "default_profile": ({"nodes": pworkloads.make_nodes(6, seed=9, taint_fraction=0.3),
                             "pods": pworkloads.make_pods(8, seed=10, with_affinity=True,
                                                          with_tolerations=True)}, {},
                            [{"urlPrefix": url, "filterVerb": "filter",
                              "prioritizeVerb": "prioritize", "weight": 3}]),
    }


@pytest.mark.parametrize("case", ["filter_prioritize", "bind", "preempt", "default_profile"])
def test_extender_path_matches_jax(fake_extender, case):
    objects, cfg_kw, ext_cfgs = _extender_cases(fake_extender)[case]
    bound, snap = _with_extenders(PORT, pextender, objects, cfg_kw, ext_cfgs)
    bound_ref, ref = _with_extenders(JAX, jextender, objects, cfg_kw, ext_cfgs)
    assert bound == bound_ref and bound > 0
    assert_same(snap, ref)
    a = next(iter(snap.values()))[4]
    if case == "preempt":
        urgent = snap[("default", "urgent")]
        assert urgent[0] == "node-b" and ("default", "victim-node-b") not in snap
        a = urgent[4]
        assert json.loads(a[ann.EXTENDER_PREEMPT_RESULT])
    elif case == "bind":
        assert a[ann.BIND_RESULT] == "{}" and json.loads(a[ann.EXTENDER_BIND_RESULT])
    else:
        assert all(v[0] != "node-00000" for v in snap.values())
        assert ann.EXTENDER_PRIORITIZE_RESULT in a


def _hooks(mod):
    """Plugin-extender hooks on in-tree plugins of config 5."""

    class Invert(mod.PluginExtender):
        def after_score(self, pod, node_name, score):
            return 1000 - 3 * score

    class VetoOdd(mod.PluginExtender):
        def before_filter(self, pod, node_name):
            return "vetoed" if node_name.endswith(("3", "7")) else None

    class Resurrect(mod.PluginExtender):
        def after_filter(self, pod, node_name, msg):
            return None if node_name.endswith("1") else msg

    class Boost(mod.PluginExtender):
        def after_score(self, pod, node_name, score):
            return score + (7 if node_name.endswith("2") else 0)

        def after_normalize(self, pod, scores):
            out = dict(scores)
            first = sorted(out)[0] if out else None
            if first is not None:
                out[first] = 10_000
            return out

    class Observe(mod.PluginExtender):
        def after_cycle(self, pod, annotations, result_store):
            meta = pod.get("metadata") or {}
            result_store.add_custom_result(meta.get("namespace") or "default",
                                           meta.get("name", ""), "observed",
                                           annotations[ann.SELECTED_NODE])

    return {
        "after_score_affinity": {"NodeAffinity": Invert()},
        "after_score_spread_interpod": {"PodTopologySpread": Invert(),
                                        "InterPodAffinity": Boost()},
        "taint_filters": {"TaintToleration": Resurrect(), "NodeAffinity": VetoOdd(),
                          "NodeResourcesFit": Boost()},
        "observer": {"_observer0": Observe()},
    }


def _with_hooks(pkg, mod, case, objects, cfg_kw):
    store = fill(pkg, objects)
    engine = pkg.Engine(store, plugin_config=pkg.Cfg(**cfg_kw), **pkg.kw)
    engine.plugin_extenders = _hooks(mod)[case]
    host = engine._needs_host_path()
    bound = engine.schedule_pending()
    engine.close()
    return bound, snapshot(store), host


@pytest.mark.parametrize("case", ["after_score_affinity", "after_score_spread_interpod",
                                  "taint_filters", "observer"])
def test_plugin_extender_hooks_match_jax(case):
    nodes, pods, cfg = pworkloads.baseline_config(5, scale=0.01, seed=0)
    objects, cfg_kw = {"nodes": nodes, "pods": pods[:30]}, {"enabled": list(cfg.enabled)}
    launches = kphased.renormalize_row.launches
    bound, snap, host = _with_hooks(PORT, pdebuggable, case, objects, cfg_kw)
    bound_ref, ref, host_ref = _with_hooks(JAX, jdebuggable, case, objects, cfg_kw)
    assert host == host_ref == (case != "observer")
    assert bound == bound_ref and bound > 0
    assert_same(snap, ref)
    assert kphased.renormalize_row.launches == launches  # the CPU runs the plain version
