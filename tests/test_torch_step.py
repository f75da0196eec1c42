"""The port's build_step against the JAX package's build_step.

The plain PyTorch step (what the CPU runs and what the card's kernel is
held to) must give the JAX step's outputs and carry, exactly, pod after
pod: in "full" mode and in "compact" mode under every pack mode and
raw-width tier, on the tiny workload of __graft_entry__._tiny_workload
(restricted to the six ported plugins) and on config 5 at test scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.framework.pipeline import build_step as jax_build_step
from kube_scheduler_simulator_tpu.models.workloads import baseline_config as jax_baseline_config
from kube_scheduler_simulator_tpu.models.workloads import make_nodes as jax_make_nodes
from kube_scheduler_simulator_tpu.models.workloads import make_pods as jax_make_pods
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JPluginSetConfig
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu_torch.framework.pipeline import PACK_MODES, build_step
from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _slice_xs
from kube_scheduler_simulator_tpu_torch.models import baseline_config, make_nodes, make_pods
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload

SIX = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
       "TaintToleration", "PodTopologySpread", "InterPodAffinity"]


def _tiny(mk_nodes, mk_pods, cfg_cls):
    # the construction of __graft_entry__._tiny_workload, six plugins
    nodes = mk_nodes(8, seed=3, taint_fraction=0.2)
    pods = mk_pods(16, seed=4, with_affinity=True, with_tolerations=True,
                   with_spread=True, with_interpod=True)
    return nodes, pods, cfg_cls(enabled=list(SIX))


WORKLOADS = {
    "tiny": (lambda: _tiny(make_nodes, make_pods, PluginSetConfig),
             lambda: _tiny(jax_make_nodes, jax_make_pods, JPluginSetConfig)),
    "config5": (lambda: baseline_config(5, scale=0.01, seed=0),
                lambda: jax_baseline_config(5, scale=0.01, seed=0)),
}
MODES = ([("full", "p16", None)]
         + [("compact", pm, None) for pm in PACK_MODES]
         + [("compact", "p16", "i32"), ("compact", "p16", "i64")])
N_PODS = 16

_CW = {}
_JAX_RUNS = {}


def workloads(name):
    if name not in _CW:
        port, ref = WORKLOADS[name]
        _CW[name] = (compile_workload(*port(), device="cpu"), jax_compile(*ref()))
    return _CW[name]


def _is_pad(cw):
    # the last two steps are padding: they must select -1 and bind nothing
    k = min(N_PODS, cw.n_pods)
    return np.arange(k) >= k - 2


def jax_runs(name):
    """The JAX step scanned over the first pods, for every mode of MODES,
    as one jitted program per workload (one XLA compile instead of one per
    mode): {mode: (carry, outs)}."""
    if name not in _JAX_RUNS:
        cw, jcw = workloads(name)
        is_pad = _is_pad(cw)
        jxs = jax.tree.map(lambda a: a[:len(is_pad)], jcw.xs)
        jxs["is_pad"] = jnp.asarray(is_pad)
        steps = [jax_build_step(jcw, out_mode=m, pack_mode=p, score_dtypes=jcw.host["score_dtypes"],
                                wide_raw=w) for m, p, w in MODES]
        runs = jax.jit(lambda c, x: [jax.lax.scan(s, c, x) for s in steps])(jcw.init_carry, jxs)
        _JAX_RUNS[name] = dict(zip(MODES, runs))
    return _JAX_RUNS[name]


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("wl", list(WORKLOADS))
@pytest.mark.parametrize("out_mode,pack_mode,wide", MODES,
                         ids=[f"{m}-{p}-{w}" for m, p, w in MODES])
def test_step_matches_jax(wl, out_mode, pack_mode, wide):
    cw, _ = workloads(wl)
    is_pad = _is_pad(cw)
    k = len(is_pad)
    step = build_step(cw, out_mode=out_mode, pack_mode=pack_mode,
                      score_dtypes=cw.host["score_dtypes"], wide_raw=wide)
    xs = _slice_xs(cw.xs, 0, k, k)
    xs["is_pad"] = torch.from_numpy(is_pad)
    carry, outs = step.scan(_clone_carry(cw.init_carry), xs)
    jcarry, jouts = jax_runs(wl)[(out_mode, pack_mode, wide)]
    assert type(outs).__name__ == type(jouts).__name__
    for f in jouts._fields:
        a, b = _np(getattr(outs, f)), _np(getattr(jouts, f))
        assert a.dtype == b.dtype, f"{f}: {a.dtype} vs {b.dtype}"
        assert a.shape == b.shape, f"{f}: {a.shape} vs {b.shape}"
        assert np.array_equal(a, b), f"{f} differs"
    assert (_np(outs.selected)[is_pad] == -1).all()
    for name, sub in jcarry.items():
        ref = [sub] if not hasattr(sub, "_fields") else list(sub)
        got = [carry[name]] if not hasattr(carry[name], "_fields") else list(carry[name])
        for a, b in zip(got, ref):
            assert np.array_equal(_np(a), _np(b)), f"carry {name} differs"


def test_single_pod_call_matches_scan():
    """Step.__call__ (one pod) is a chunk of one through the same path."""
    cw, _ = workloads("config5")
    step = build_step(cw, out_mode="full")
    xs = _slice_xs(cw.xs, 0, 3, 3)
    xs["is_pad"] = torch.zeros(3, dtype=torch.bool)
    carry_a, outs = step.scan(_clone_carry(cw.init_carry), xs)
    carry_b = _clone_carry(cw.init_carry)
    for i in range(3):
        sl = {k: type(v)(*[a[i] for a in v]) if hasattr(v, "_fields") else v[i]
              for k, v in xs.items()}
        carry_b, out = step(carry_b, sl)
        for f in out._fields:
            assert torch.equal(getattr(out, f), getattr(outs, f)[i]), f
    assert torch.equal(carry_a["core"].requested, carry_b["core"].requested)
