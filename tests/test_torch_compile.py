"""The port's workload generators and compiler against the JAX package's.

kube_scheduler_simulator_tpu_torch.models / .state.compile must give the
same manifests and the same tensors, leaf for leaf (exact: every leaf is
an integer, bool or float64 array built by the same host code), as
kube_scheduler_simulator_tpu on BASELINE configs 1-5 at the scales of
tests/test_parity.py.
"""

import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.models.workloads import baseline_config as jax_baseline_config
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu_torch.models import baseline_config
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload

SCALES = [(1, 1.0), (2, 0.1), (3, 0.02), (4, 0.01), (5, 0.01)]


def _leaves(tree, prefix=""):
    """{path: numpy array or int} of a dict of arrays / NamedTuples."""
    out = {}
    for key, v in tree.items():
        if hasattr(v, "_fields"):
            for f in v._fields:
                out[f"{prefix}{key}.{f}"] = getattr(v, f)
        else:
            out[f"{prefix}{key}"] = v
    return {k: (int(v) if isinstance(v, int) else
                v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def assert_trees_equal(port_tree, jax_tree, what):
    a, b = _leaves(port_tree), _leaves(jax_tree)
    assert sorted(a) == sorted(b), f"{what}: leaves {sorted(a)} vs {sorted(b)}"
    for k in a:
        if isinstance(b[k], int):
            assert a[k] == b[k], f"{what} {k}"
            continue
        assert a[k].dtype == b[k].dtype, f"{what} {k}: {a[k].dtype} vs {b[k].dtype}"
        assert a[k].shape == b[k].shape, f"{what} {k}: {a[k].shape} vs {b[k].shape}"
        assert np.array_equal(a[k], b[k]), f"{what} {k}: values differ"


def assert_host_flags_equal(cw, jcw):
    for key in ("filter_skip", "score_skip"):
        assert sorted(cw.host[key]) == sorted(jcw.host[key])
        for name in cw.host[key]:
            assert np.array_equal(cw.host[key][name], jcw.host[key][name]), (key, name)
    for key in ("max_filter_code", "score_dtypes"):
        assert cw.host[key] == jcw.host[key], key
    assert ("tsp_ignore" in cw.host) == ("tsp_ignore" in jcw.host)
    for a, b in zip(cw.host.get("tsp_ignore", ()), jcw.host.get("tsp_ignore", ())):
        assert np.array_equal(a, b)
    rows, jrows = cw.host.get("static_score_rows", {}), jcw.host.get("static_score_rows", {})
    assert sorted(rows) == sorted(jrows)
    for name in rows:
        assert rows[name].dtype == jrows[name].dtype
        assert np.array_equal(rows[name], jrows[name]), name


@pytest.mark.parametrize("idx,scale", SCALES)
def test_baseline_manifests_equal(idx, scale):
    nodes, pods, cfg = baseline_config(idx, scale=scale, seed=7)
    jnodes, jpods, jcfg = jax_baseline_config(idx, scale=scale, seed=7)
    assert nodes == jnodes
    assert pods == jpods
    assert cfg.enabled == jcfg.enabled
    assert cfg.filters() == jcfg.filters() and cfg.scorers() == jcfg.scorers()


@pytest.mark.parametrize("idx,scale", SCALES)
def test_compile_workload_equal(idx, scale):
    nodes, pods, cfg = baseline_config(idx, scale=scale, seed=0)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    jcw = jax_compile(*jax_baseline_config(idx, scale=scale, seed=0))
    assert cw.n_pods == jcw.n_pods and cw.n_nodes == jcw.n_nodes
    assert cw.schema.columns == jcw.schema.columns
    assert cw.pod_keys == jcw.pod_keys
    assert_trees_equal(cw.statics, jcw.statics, "statics")
    assert_trees_equal(cw.xs, jcw.xs, "xs")
    assert_trees_equal(cw.init_carry, jcw.init_carry, "init_carry")
    assert_host_flags_equal(cw, jcw)


def test_compile_bound_pods_equal():
    """Already-bound pods prime the core, spread and InterPod carries."""
    nodes, pods, cfg = baseline_config(5, scale=0.01, seed=3)
    jnodes, jpods, jcfg = jax_baseline_config(5, scale=0.01, seed=3)
    names = [nd["metadata"]["name"] for nd in nodes]
    bound = [(pods[i], names[i % len(names)]) for i in range(0, 40, 3)]
    jbound = [(jpods[i], names[i % len(names)]) for i in range(0, 40, 3)]
    cw = compile_workload(nodes, pods[40:], cfg, bound_pods=bound, device="cpu")
    jcw = jax_compile(jnodes, jpods[40:], jcfg, bound_pods=jbound)
    assert_trees_equal(cw.statics, jcw.statics, "statics")
    assert_trees_equal(cw.xs, jcw.xs, "xs")
    assert_trees_equal(cw.init_carry, jcw.init_carry, "init_carry")
    assert_host_flags_equal(cw, jcw)


def test_compile_refuses_plugins_outside_the_slice():
    """Every default plugin compiles, and since B13 every custom
    (out-of-tree) plugin too, as its [P, N] rows; what lies outside is a
    plugin neither in the registry nor in the config's custom map, which
    the config refuses."""
    from types import SimpleNamespace

    nodes, pods, _ = baseline_config(1, scale=0.1, seed=0)

    def veto(pod, node):
        return None if node["metadata"]["name"].endswith("0") else "guest says no"

    guest = SimpleNamespace(has_filter=True, has_score=False, default_weight=1, filter=veto)
    cfg = PluginSetConfig(enabled=["NodeResourcesFit", "GuestFilter"],
                          custom={"GuestFilter": guest})
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    assert cw.host["custom_msgs"]["GuestFilter"] == ["guest says no"]
    codes = cw.xs["GuestFilter"].codes
    want = [[0 if n["metadata"]["name"].endswith("0") else 1 for n in nodes]] * len(pods)
    assert codes.tolist() == want
    with pytest.raises(ValueError, match="unknown plugin GuestFilter"):
        PluginSetConfig(enabled=["NodeResourcesFit", "GuestFilter"])
    compile_workload(nodes, pods, PluginSetConfig(enabled=["NodeResourcesFit", "NodePorts"]),
                     device="cpu")


@pytest.mark.parametrize("volumes_on", [True, False], ids=["volumes", "no_volumes"])
def test_compile_default_profile_equal(volumes_on):
    """PluginSetConfig() on a decorated fleet (chip_smoke.py's decoration):
    every static, per-pod and carry leaf of the 14 plugins, the
    compile-time PreFilter rejects and the host rows equal the JAX
    package's."""
    import chip_smoke
    from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JPluginSetConfig

    nodes, pods, _ = baseline_config(5, scale=0.02, seed=5)
    volumes, bound = chip_smoke.decorate_default_profile(nodes, pods, seed=5,
                                                         volumes_on=volumes_on)
    cw = compile_workload(nodes, pods, PluginSetConfig(), volumes=volumes, bound_pods=bound,
                          device="cpu")
    jcw = jax_compile(nodes, pods, JPluginSetConfig(), volumes=volumes, bound_pods=bound)
    assert_trees_equal(cw.statics, jcw.statics, "statics")
    assert_trees_equal(cw.xs, jcw.xs, "xs")
    assert_trees_equal(cw.init_carry, jcw.init_carry, "init_carry")
    assert_host_flags_equal(cw, jcw)
    assert cw.host.get("prefilter_reject") == jcw.host.get("prefilter_reject")
    assert ("force_unsched" in cw.xs) == volumes_on
