"""The step kernel (csrc/step.cu) against its plain PyTorch version, on
the card: every output and the carry equal, exactly, in "full" mode and
in "compact" mode under every pack mode and raw-width tier, on configs
1-5 at test scale, the tiny workload and a workload with per-slot spread
eligibility.  A CUDA kernel has no CPU mode, so these tests skip where
there is no card; run them on one with

    python -m pytest tests/test_torch_kernel.py -q
"""

import pytest
import torch

from kube_scheduler_simulator_tpu_torch.framework.pipeline import PACK_MODES, build_step
from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _slice_xs
from kube_scheduler_simulator_tpu_torch.kernels import step as kstep
from kube_scheduler_simulator_tpu_torch.models import baseline_config, make_nodes, make_pods
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload

pytestmark = pytest.mark.cuda

SIX = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
       "TaintToleration", "PodTopologySpread", "InterPodAffinity"]
MODES = ([("full", "p16", None)]
         + [("compact", pm, w) for pm in PACK_MODES for w in (None, "i32", "i64")])


def _policies():
    nodes = make_nodes(24, seed=5, taint_fraction=0.3)
    pods = make_pods(40, seed=6, with_affinity=True, with_tolerations=True,
                     with_spread=True, with_interpod=True)
    for i, pod in enumerate(pods):
        for c in pod["spec"].get("topologySpreadConstraints", []):
            if i % 3 == 0:
                c["nodeTaintsPolicy"] = "Honor"
            if i % 5 == 2 and c["whenUnsatisfiable"] == "DoNotSchedule":
                c["minDomains"] = 12
    return nodes, pods, PluginSetConfig(enabled=list(SIX))


WORKLOADS = {
    **{f"config{i}": (lambda i=i, s=s: baseline_config(i, scale=s, seed=0))
       for i, s in ((1, 1.0), (2, 0.1), (3, 0.02), (4, 0.01), (5, 0.05))},
    "tiny": lambda: (make_nodes(8, seed=3, taint_fraction=0.2),
                     make_pods(16, seed=4, with_affinity=True, with_tolerations=True,
                               with_spread=True, with_interpod=True),
                     PluginSetConfig(enabled=list(SIX))),
    "policies": _policies,
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the step kernel has no CPU mode")
    return torch.device("cuda", 0)


def _leaves(carry):
    for v in carry.values():
        yield from ([v] if isinstance(v, torch.Tensor) else list(v))


@pytest.mark.parametrize("wl", list(WORKLOADS))
def test_kernel_matches_plain(card, wl):
    cw = compile_workload(*WORKLOADS[wl](), device=card)
    chunk = 32
    for out_mode, pack_mode, wide in MODES:
        step = build_step(cw, out_mode=out_mode, pack_mode=pack_mode,
                          score_dtypes=cw.host["score_dtypes"], wide_raw=wide)
        ck, cp = _clone_carry(cw.init_carry), _clone_carry(cw.init_carry)
        launches = kstep.step_chunk.launches
        for lo in range(0, cw.n_pods, chunk):
            hi = min(lo + chunk, cw.n_pods)
            xs = _slice_xs(cw.xs, lo, hi, chunk)
            xs["is_pad"] = torch.arange(chunk, device=card) >= (hi - lo)
            ck, ok = step.scan(ck, xs)
            cp, op = step.plain_scan(cp, xs)
            for f in ok._fields:
                a, b = getattr(ok, f), getattr(op, f)
                assert a.dtype == b.dtype and a.shape == b.shape, f
                assert torch.equal(a.cpu(), b.cpu()), (out_mode, pack_mode, wide, lo, f)
            for a, b in zip(_leaves(ck), _leaves(cp)):
                assert torch.equal(a, b), (out_mode, pack_mode, wide, lo, "carry")
        assert kstep.step_chunk.launches - launches == -(-cw.n_pods // chunk)
