"""`unroll=` on the port's replay and speculative stream.

The JAX package takes `unroll` as lax.scan's unroll factor, a hint that
cannot change a result.  The port takes it the same way: the step kernel
walks a chunk's pods in one launch, so any value of at least 1 gives the
same result as 1, and a value below 1 raises, as lax.scan refuses it."""

from __future__ import annotations

import numpy as np
import pytest

from kube_scheduler_simulator_tpu_torch.framework.replay import replay
from kube_scheduler_simulator_tpu_torch.models import baseline_config
from kube_scheduler_simulator_tpu_torch.parallel.speculative import replay_speculative_stream
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result


@pytest.fixture(scope="module")
def workload():
    nodes, pods, cfg = baseline_config(5, scale=0.004, seed=3)
    return compile_workload(nodes, pods, cfg, device="cpu"), pods


def _same(a, b):
    np.testing.assert_array_equal(a.selected, b.selected)
    np.testing.assert_array_equal(a.feasible_count, b.feasible_count)
    for i in range(len(a.selected)):
        da, db = decode_pod_result(a, i), decode_pod_result(b, i)
        assert all(da[k] == db[k] for k in ALL_PLUGIN_KEYS), i


def test_replay_unroll_2_equals_unroll_1(workload):
    cw, _ = workload
    base = replay(cw, chunk=16, device="cpu")
    _same(replay(cw, chunk=16, unroll=2, device="cpu"), base)
    assert base.scheduled > 0


def test_stream_unroll_2_equals_unroll_1(workload):
    cw, pods = workload
    base, stats = replay_speculative_stream(cw, chunk=16, pods=pods, device="cpu")
    got, stats2 = replay_speculative_stream(cw, chunk=16, unroll=2, pods=pods, device="cpu")
    _same(got, base)
    assert stats2["rounds"] == stats["rounds"]


@pytest.mark.parametrize("unroll", [0, -1])
def test_unroll_below_one_raises_as_lax_scan_does(workload, unroll):
    cw, pods = workload
    with pytest.raises(ValueError, match="unroll"):
        replay(cw, chunk=16, unroll=unroll, device="cpu")
    with pytest.raises(ValueError, match="unroll"):
        replay_speculative_stream(cw, chunk=16, unroll=unroll, pods=pods, device="cpu")
