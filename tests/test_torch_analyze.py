"""The port through the JAX package's static analyzers (tools/analysis).

`run_analysis(package="kube_scheduler_simulator_tpu_torch")` runs the
lock-discipline, device-purity, span and swallowed-exception analyzers
over the port.  The JAX package grandfathers its known findings in
tools/analysis/baseline.json; the port is a module-for-module copy, so a
finding of the port passes where the baseline holds the same fingerprint
with the package's name mapped back (`kube_scheduler_simulator_tpu_torch`
-> `kube_scheduler_simulator_tpu`, in paths and in the dotted lock names).
Any other finding is the port's own and fails here: fix it, or justify it
in source with `# kss-analyze: allow(rule)`, as the JAX package does."""

from __future__ import annotations

import pytest

from tools.analysis import run_analysis
from tools.analysis.baseline import load_baseline

PORT = "kube_scheduler_simulator_tpu_torch"
JAX = "kube_scheduler_simulator_tpu"


def _as_jax(fingerprint: str) -> str:
    return fingerprint.replace(PORT, JAX)


@pytest.fixture(scope="module")
def res():
    return run_analysis(package=PORT)


def test_the_port_has_no_finding_beyond_the_jax_baseline(res):
    assert res["modules"] > 100, "the analyzers found too few of the port's modules"
    baseline = load_baseline()
    new = [f for f in res["findings"] if _as_jax(f.fingerprint) not in baseline]
    assert not new, "\n".join(f.render() for f in new)
    # the mapping is not vacuous: the port repeats grandfathered findings
    assert any(_as_jax(f.fingerprint) in baseline for f in res["findings"])


def test_the_compile_spans_pass_the_prometheus_rules(res):
    """The compile's spans (state/compile.py) are valid metric names: no
    metric-name or unbalanced-span finding anywhere in the port."""
    bad = [f for f in res["findings"] if f.rule in ("metric-name", "unbalanced-span")]
    assert not bad, "\n".join(f.render() for f in bad)
