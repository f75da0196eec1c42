"""The port's chunked replay and decode against the JAX package and the
scalar oracle.

On BASELINE configs 1-5 at the scales of tests/test_parity.py, every
pod's selected node and 13 annotation blobs from
kube_scheduler_simulator_tpu_torch (replay + decode_pod_result, on the
CPU) must be byte-identical to both the JAX replay + decode and
SequentialScheduler(...).schedule_all().  Also: the raw-width ladder, the
port's independence from JAX, and the refusal to run on a missing card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kube_scheduler_simulator_tpu.framework.replay import replay as jax_replay
from kube_scheduler_simulator_tpu.models.workloads import baseline_config as jax_baseline_config
from kube_scheduler_simulator_tpu.models.workloads import make_nodes as jax_make_nodes
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JPluginSetConfig
from kube_scheduler_simulator_tpu.reference_impl.sequential import SequentialScheduler
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu_torch.framework import replay
from kube_scheduler_simulator_tpu_torch.models import baseline_config, make_nodes
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result

REPO = Path(__file__).resolve().parent.parent
SIX = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
       "TaintToleration", "PodTopologySpread", "InterPodAffinity"]


def assert_three_way(rr, jrr, seq_results):
    assert len(seq_results) == rr.cw.n_pods
    for i, (seq_ann, seq_sel) in enumerate(seq_results):
        ann = decode_pod_result(rr, i)
        assert sorted(ann) == sorted(ALL_PLUGIN_KEYS)
        assert int(rr.selected[i]) == int(jrr.selected[i]) == seq_sel, f"pod {i}: selected"
        jann = jax_decode(jrr, i)
        for key in ALL_PLUGIN_KEYS:
            assert ann[key] == jann[key], f"pod {i} {key}: port vs JAX\n{ann[key][:300]}\n{jann[key][:300]}"
            assert ann[key] == seq_ann[key], f"pod {i} {key}: port vs oracle"


@pytest.mark.parametrize("idx,scale", [(1, 1.0), (2, 0.1), (3, 0.02), (4, 0.01), (5, 0.01)])
def test_replay_matches_jax_and_oracle(idx, scale):
    nodes, pods, cfg = baseline_config(idx, scale=scale, seed=0)
    rr = replay(compile_workload(nodes, pods, cfg, device="cpu"), chunk=64, device="cpu")
    jnodes, jpods, jcfg = jax_baseline_config(idx, scale=scale, seed=0)
    jrr = jax_replay(jax_compile(jnodes, jpods, jcfg), chunk=64)
    seq = SequentialScheduler(jnodes, jpods, jcfg).schedule_all()
    assert rr.scheduled > 0
    assert rr.tiers == (None,)
    assert_three_way(rr, jrr, seq)


def _ladder_workload(mk_nodes, cfg_cls, hard_weight):
    """Bound anchor pods carry required pod-affinity terms on three
    topology keys; every queue pod matches all three, so its InterPod raw
    at the anchors' node is 3 x hardPodAffinityWeight — past int16 for
    20000, past int32 for 2**30 — and the replay climbs the ladder."""
    nodes = mk_nodes(6, seed=1)
    keys = ("kubernetes.io/hostname", "topology.kubernetes.io/zone",
            "topology.kubernetes.io/region")

    def pod(name, terms=()):
        spec = {"containers": [{"name": "main", "resources": {
            "requests": {"cpu": "100m", "memory": str(64 << 20)}}}]}
        if terms:
            spec["affinity"] = {"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
                {"topologyKey": k, "labelSelector": {"matchLabels": {"app": "web"}}} for k in terms]}}
        return {"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": name, "namespace": "default", "labels": {"app": "web"}},
                "spec": spec}

    bound = [(pod(f"anchor-{k}", terms=(key,)), "node-00000") for k, key in enumerate(keys)]
    pods = [pod(f"q-{i}") for i in range(10)]
    cfg = cfg_cls(enabled=list(SIX), args={"InterPodAffinity": {"hardPodAffinityWeight": hard_weight}})
    return nodes, pods, cfg, bound


@pytest.mark.parametrize("hard_weight,tiers", [(20000, (None, "i32")),
                                               (1 << 30, (None, "i32", "i64"))])
def test_width_ladder_matches_jax_and_oracle(hard_weight, tiers):
    nodes, pods, cfg, bound = _ladder_workload(make_nodes, PluginSetConfig, hard_weight)
    rr = replay(compile_workload(nodes, pods, cfg, bound_pods=bound, device="cpu"),
                chunk=4, device="cpu")
    assert rr.tiers == tiers
    jnodes, jpods, jcfg, jbound = _ladder_workload(jax_make_nodes, JPluginSetConfig, hard_weight)
    jrr = jax_replay(jax_compile(jnodes, jpods, jcfg, bound_pods=jbound), chunk=4)
    seq = SequentialScheduler(jnodes, jpods, jcfg, bound_pods=jbound).schedule_all()
    assert_three_way(rr, jrr, seq)


def test_replay_twice_starts_clean():
    """The kernel path updates the carry in place; replay copies the
    initial carry first, so a second replay of one workload is equal."""
    nodes, pods, cfg = baseline_config(5, scale=0.01, seed=2)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    before = cw.init_carry["core"].requested.clone()
    a, b = replay(cw, chunk=32, device="cpu"), replay(cw, chunk=32, device="cpu")
    assert (a.selected == b.selected).all()
    assert torch.equal(cw.init_carry["core"].requested, before)
    assert decode_pod_result(a, 7) == decode_pod_result(b, 7)


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py, loads
    neither JAX nor the JAX package (a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import kube_scheduler_simulator_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'kube_scheduler_simulator_tpu')\n"
        "       or m.startswith(('jax.', 'kube_scheduler_simulator_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_no_jax_import():
    """No import statement in the port or chip_smoke.py, lazy ones
    included, names jax or the JAX package."""
    files = sorted((REPO / "kube_scheduler_simulator_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    banned = ("jax", "kube_scheduler_simulator_tpu")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not any(name == b or name.startswith(b + ".") for b in banned), (
                    f"{path}: imports {name}")


def test_default_device_needs_a_card(monkeypatch):
    """Entry points default to the card and refuse to run without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nodes, pods, cfg = baseline_config(1, scale=0.1, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_workload(nodes, pods, cfg)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replay(cw, chunk=8)
