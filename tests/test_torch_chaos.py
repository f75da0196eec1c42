"""The port's chaos gate (kube_scheduler_simulator_tpu_torch/tools/chaos.py)
on the CPU.

`run_seed` at the JAX tool's QUICK_SHAPE drives two concurrent sessions
of the port's engine under the seed's fault plan over every seam, under
the port's lock witness, and must pass every invariant.  Its fault-free
reference run must equal, byte for byte, the JAX package's engine on the
same cluster (tools/chaos.py `_build_cluster` and `_engine`): every pod's
node and all its annotations, for both sessions.  The three-seed gate at
FULL_SHAPE is slow, as tests/test_chaos.py's is."""

from __future__ import annotations

import pytest

from kube_scheduler_simulator_tpu.cluster.store import ObjectStore as JaxStore
from kube_scheduler_simulator_tpu_torch.tools import chaos, lockwitness
from tools import chaos as jchaos


def test_quick_seed_passes_and_its_fault_free_run_equals_the_jax_engine():
    witness = lockwitness.install()
    try:
        r = chaos.run_seed(1, chaos.QUICK_SHAPE, witness=witness, device="cpu",
                           keep_state=True)
    finally:
        lockwitness.uninstall()
    assert r["ok"], r["failures"]
    assert r["injected"] >= 1
    assert set(r["modes"]) == {chaos.FAULTED, chaos.NEIGHBOR}
    assert r["modes"][chaos.NEIGHBOR] == "device_resident"
    shape = chaos.QUICK_SHAPE
    for i, sid in enumerate((chaos.FAULTED, chaos.NEIGHBOR)):
        store = JaxStore()
        jchaos._build_cluster(store, seed=1 + 50 * i, n_nodes=shape["nodes"],
                              n_pods=shape["pods"], gangs=shape["gangs"],
                              gang_members=shape["gang_members"])
        eng = jchaos._engine(store, sid, chunk=shape["chunk"])
        eng.schedule_pending()
        want = jchaos._collect_state(store, sid)
        eng.close()
        got = r["reference"][sid]
        assert set(got) == set(want), sid
        for name in want:
            assert got[name] == want[name], (sid, name)
        assert any(node for node, _ in got.values())


def test_the_plans_match_the_jax_tool_rule_for_rule():
    for seed in (1, 2, 3, 11):
        ours = chaos._plan_for(seed, chaos.FAULTED).stats()["rules"]
        theirs = jchaos._plan_for(seed, jchaos.FAULTED).stats()["rules"]
        assert [(r["seam"], r["error"]) for r in ours] == \
            [(r["seam"], r["error"]) for r in theirs]
        assert [(r.nth, r.p, r.times) for r in chaos._plan_for(seed, "x").rules] == \
            [(r.nth, r.p, r.times) for r in jchaos._plan_for(seed, "x").rules]


@pytest.mark.slow
def test_chaos_gate_three_seeds():
    verdict = chaos.chaos_verdict(seeds=3, seed_base=1, device="cpu")
    assert verdict["ok"], "\n".join(verdict["failures"])
    assert verdict["injected_total"] >= 3
