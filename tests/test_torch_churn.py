"""The port's churn generator (models/workloads.py make_churn_workload)
against the JAX package's: for the same arguments the same nodes and the
same tick schedule, byte for byte as JSON.  One np.random.default_rng
drives both, in the same order."""

from __future__ import annotations

import json

import pytest

from kube_scheduler_simulator_tpu.models.workloads import make_churn_workload as jax_churn
from kube_scheduler_simulator_tpu_torch.models import make_churn_workload


@pytest.mark.parametrize("kw", [
    dict(n_nodes=48, ticks=18, seed=5, arrival_rate=8.0, departure_rate=4.0,
         name_prefix="soak"),                                  # the soak's default stream
    dict(n_nodes=5000, ticks=18, seed=5, arrival_rate=64, departure_rate=32),
    dict(n_nodes=7, ticks=1, seed=0),                          # the generator's defaults
    dict(n_nodes=10, ticks=40, seed=3, arrival_rate=1.5, departure_rate=9.0,
         slot_size=3),                                         # departures outrun arrivals
    dict(n_nodes=1, ticks=0, seed=11, arrival_rate=0.0, departure_rate=0.0,
         slot_size=0),                                         # the clamps: one tick, one slot
])
def test_churn_workload_equals_the_jax_generator(kw):
    nodes, schedule = make_churn_workload(**kw)
    jnodes, jschedule = jax_churn(**kw)
    assert json.dumps(nodes, sort_keys=True) == json.dumps(jnodes, sort_keys=True)
    assert json.dumps(schedule, sort_keys=True) == json.dumps(jschedule, sort_keys=True)
    assert len(schedule) == max(kw["ticks"], 1)
    seen: set[str] = set()
    for tick in schedule:   # departures only name pods that arrived earlier
        assert set(tick["delete"]) <= seen
        seen |= {p["metadata"]["name"] for p in tick["create"]}
        seen -= set(tick["delete"])
