"""The port's volume family (VolumeBinding, VolumeZone, VolumeRestrictions,
NodeVolumeLimits) against the JAX package and the scalar oracle.

One case for each test of tests/test_volumes.py, on the same manifests:
every run of the case goes through the port (compile_workload + replay +
decode_pod_result, on the CPU), the JAX replay + decode and
SequentialScheduler, and every pod's selected node and 13 annotation
blobs must be byte-identical across the three.  Each case then checks the
behaviour its JAX counterpart asserts on the port's own result.
"""

import json

import pytest

from kube_scheduler_simulator_tpu.framework.replay import replay as jax_replay
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JPluginSetConfig
from kube_scheduler_simulator_tpu.reference_impl.sequential import SequentialScheduler
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu_torch.framework import replay
from kube_scheduler_simulator_tpu_torch.plugins import (
    nodevolumelimits, volumebinding, volumerestrictions, volumezone,
)
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import annotations as ann
from kube_scheduler_simulator_tpu_torch.store import decode_pod_result
from test_volumes import node, pod, pv, pvc, sc

VOL = ["NodeResourcesFit", "VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding",
       "VolumeZone"]
NO_PROV = "kubernetes.io/no-provisioner"


def run(nodes, pods, volumes, enabled=None, bound=None, chunk=4):
    """The port's result of one run, held byte-identical to the JAX replay
    and the oracle on every pod -> (port ReplayResult, annotations)."""
    port_cfg = PluginSetConfig(enabled=list(enabled)) if enabled else PluginSetConfig()
    jax_cfg = JPluginSetConfig(enabled=list(enabled)) if enabled else JPluginSetConfig()
    rr = replay(compile_workload(nodes, pods, port_cfg, bound_pods=bound, volumes=volumes,
                                 device="cpu"), chunk=chunk, device="cpu")
    jrr = jax_replay(jax_compile(nodes, pods, jax_cfg, bound_pods=bound, volumes=volumes),
                     chunk=chunk)
    seq = SequentialScheduler(nodes, pods, jax_cfg, bound_pods=bound,
                              volumes=volumes).schedule_all()
    anns = []
    for i, (seq_ann, seq_sel) in enumerate(seq):
        a, ja = decode_pod_result(rr, i), jax_decode(jrr, i)
        assert int(rr.selected[i]) == int(jrr.selected[i]) == seq_sel, f"pod {i}: selected"
        assert int(rr.prefilter_reject[i]) == int(jrr.prefilter_reject[i]), f"pod {i}: reject"
        for key in ann.ALL_PLUGIN_KEYS:
            assert a[key] == ja[key], f"pod {i} {key}: port vs JAX\n{a[key]}\n{ja[key]}"
            assert a[key] == seq_ann[key], f"pod {i} {key}: port vs oracle"
        anns.append(a)
    return rr, anns


def filter_entry(a, node_name):
    return json.loads(a[ann.FILTER_RESULT]).get(node_name, {})


def case_volume_zone_conflict_and_skip():
    nodes = [node("n-east", {"topology.kubernetes.io/zone": "east"}),
             node("n-west", {"topology.kubernetes.io/zone": "west"})]
    volumes = {"pvcs": [pvc("data", sc="", volume_name="pv-east")],
               "pvs": [pv("pv-east", labels={"topology.kubernetes.io/zone": "east"})]}
    _, a = run(nodes, [pod("p1", pvcs=["data"]), pod("p2")], volumes, VOL)
    assert filter_entry(a[0], "n-west")["VolumeZone"] == volumezone.ERR_VOLUME_ZONE_CONFLICT
    assert filter_entry(a[0], "n-east")["VolumeZone"] == ann.PASSED_FILTER_MESSAGE
    assert json.loads(a[1][ann.PRE_FILTER_STATUS_RESULT])["VolumeZone"] == ""
    volumes2 = {"pvcs": [pvc("data", sc="", volume_name="pv-multi")],
                "pvs": [pv("pv-multi", labels={"topology.kubernetes.io/zone": "west, east"})]}
    _, a2 = run(nodes, [pod("p1", pvcs=["data"])], volumes2, VOL)
    assert filter_entry(a2[0], "n-west")["VolumeZone"] == ann.PASSED_FILTER_MESSAGE


def case_bound_pv_node_affinity_conflict():
    volumes = {"pvcs": [pvc("data", sc="", volume_name="pv1")],
               "pvs": [pv("pv1", node_affinity_hosts=["n1"])]}
    _, a = run([node("n1"), node("n2")], [pod("p1", pvcs=["data"])], volumes, VOL)
    assert filter_entry(a[0], "n2")["VolumeBinding"] == volumebinding.ERR_NODE_CONFLICT
    assert a[0][ann.SELECTED_NODE] == "n1"
    assert json.loads(a[0][ann.RESERVE_RESULT]) == {"VolumeBinding": "success"}
    assert json.loads(a[0][ann.PRE_BIND_RESULT]) == {"VolumeBinding": "success"}


def case_bound_pvc_missing_pv():
    volumes = {"pvcs": [pvc("data", sc="", volume_name="ghost")], "pvs": []}
    _, a = run([node("n1")], [pod("p1", pvcs=["data"])], volumes, VOL)
    assert filter_entry(a[0], "n1")["VolumeBinding"] == volumebinding.ERR_PV_NOT_EXIST
    assert a[0][ann.SELECTED_NODE] == ""


def case_wffc_static_binding_claims_smallest_pv_and_is_consumed():
    nodes = [node("n1"), node("n2")]
    volumes = {
        "pvcs": [pvc("c1", sc="wffc-sc"), pvc("c2", sc="wffc-sc")],
        "pvs": [pv("pv-big", capacity="10Gi", sc="wffc-sc"),
                pv("pv-small", capacity="2Gi", sc="wffc-sc")],
        "storageclasses": [sc("wffc-sc", wffc=True, provisioner=NO_PROV)],
    }
    pods = [pod("p1", pvcs=["c1"]), pod("p2", pvcs=["c2"])]
    _, a = run(nodes, pods, volumes, VOL)
    assert a[0][ann.SELECTED_NODE] != "" and a[1][ann.SELECTED_NODE] != ""
    volumes3 = dict(volumes, pvcs=volumes["pvcs"] + [pvc("c3", sc="wffc-sc")])
    _, a3 = run(nodes, pods + [pod("p3", pvcs=["c3"])], volumes3, VOL)
    assert filter_entry(a3[2], "n1")["VolumeBinding"] == volumebinding.ERR_BIND_CONFLICT
    assert a3[2][ann.SELECTED_NODE] == ""


def case_wffc_pv_node_affinity_restricts_placement():
    volumes = {"pvcs": [pvc("c1", sc="local-sc")],
               "pvs": [pv("pv-n2", sc="local-sc", node_affinity_hosts=["n2"])],
               "storageclasses": [sc("local-sc", wffc=True, provisioner=NO_PROV)]}
    _, a = run([node("n1"), node("n2")], [pod("p1", pvcs=["c1"])], volumes, VOL)
    assert filter_entry(a[0], "n1")["VolumeBinding"] == volumebinding.ERR_BIND_CONFLICT
    assert a[0][ann.SELECTED_NODE] == "n2"


def case_wffc_dynamic_provisioning_allowed_topologies():
    nodes = [node("n-east", {"topology.kubernetes.io/zone": "east"}),
             node("n-west", {"topology.kubernetes.io/zone": "west"})]
    volumes = {"pvcs": [pvc("c1", sc="prov-sc")], "pvs": [],
               "storageclasses": [sc("prov-sc", wffc=True, topo_zones=["east"])]}
    _, a = run(nodes, [pod("p1", pvcs=["c1"])], volumes, VOL)
    assert filter_entry(a[0], "n-west")["VolumeBinding"] == volumebinding.ERR_BIND_CONFLICT
    assert a[0][ann.SELECTED_NODE] == "n-east"


def case_prebound_pv_claimref_matches_only_its_claim():
    volumes = {"pvcs": [pvc("mine", sc="wffc-sc"), pvc("other", sc="wffc-sc")],
               "pvs": [pv("pv1", sc="wffc-sc", claim_ref="mine")],
               "storageclasses": [sc("wffc-sc", wffc=True, provisioner=NO_PROV)]}
    _, a = run([node("n1")], [pod("p-other", pvcs=["other"])], volumes, VOL)
    assert filter_entry(a[0], "n1")["VolumeBinding"] == volumebinding.ERR_BIND_CONFLICT


def case_unbound_immediate_pvc_rejects_at_prefilter():
    volumes = {"pvcs": [pvc("c1", sc="imm-sc")], "storageclasses": [sc("imm-sc", wffc=False)]}
    rr, a = run([node("n1")], [pod("p1", pvcs=["c1"])], volumes, VOL)
    pf = json.loads(a[0][ann.PRE_FILTER_STATUS_RESULT])
    assert pf["VolumeBinding"] == volumebinding.ERR_UNBOUND_IMMEDIATE
    assert json.loads(a[0][ann.FILTER_RESULT]) == {}
    assert json.loads(a[0][ann.BIND_RESULT]) == {}
    assert a[0][ann.SELECTED_NODE] == ""
    assert int(rr.prefilter_reject[0]) & 2


def case_missing_pvc_rejects_at_volumerestrictions():
    _, a = run([node("n1")], [pod("p1", pvcs=["ghost"])], {"pvcs": []}, VOL)
    pf = json.loads(a[0][ann.PRE_FILTER_STATUS_RESULT])
    assert pf["VolumeRestrictions"] == 'persistentvolumeclaim "ghost" not found'
    assert "VolumeBinding" not in pf


def case_rwop_conflict_is_dynamic_across_the_queue():
    volumes = {"pvcs": [pvc("exclusive", sc="", volume_name="pv1", modes=("ReadWriteOncePod",))],
               "pvs": [pv("pv1", modes=("ReadWriteOncePod",), claim_ref="exclusive")]}
    pods = [pod("p1", pvcs=["exclusive"]), pod("p2", pvcs=["exclusive"])]
    rr, a = run([node("n1"), node("n2")], pods, volumes, VOL)
    assert a[0][ann.SELECTED_NODE] != ""
    pf = json.loads(a[1][ann.PRE_FILTER_STATUS_RESULT])
    assert pf["VolumeRestrictions"] == volumerestrictions.ERR_RWOP_CONFLICT
    assert a[1][ann.SELECTED_NODE] == ""
    assert int(rr.prefilter_reject[1]) & 1


def case_inline_gce_disk_conflict_readonly_exemption():
    nodes = [node("n1")]
    gce_rw = {"name": "d", "gcePersistentDisk": {"pdName": "disk-1"}}
    gce_ro = {"name": "d", "gcePersistentDisk": {"pdName": "disk-1", "readOnly": True}}
    _, a = run(nodes, [pod("p1", volumes=[gce_rw]), pod("p2", volumes=[gce_rw])], {}, VOL)
    assert filter_entry(a[1], "n1")["VolumeRestrictions"] == volumerestrictions.ERR_DISK_CONFLICT
    _, a2 = run(nodes, [pod("p1", volumes=[gce_ro]), pod("p2", volumes=[gce_ro])], {}, VOL)
    assert a2[1][ann.SELECTED_NODE] == "n1"
    ebs_ro = {"name": "d", "awsElasticBlockStore": {"volumeID": "vol-1", "readOnly": True}}
    _, a3 = run(nodes, [pod("p1", volumes=[ebs_ro]), pod("p2", volumes=[ebs_ro])], {}, VOL)
    assert filter_entry(a3[1], "n1")["VolumeRestrictions"] == volumerestrictions.ERR_DISK_CONFLICT


def _csinode(name):
    return {"apiVersion": "storage.k8s.io/v1", "kind": "CSINode", "metadata": {"name": name},
            "spec": {"drivers": [{"name": "ebs.csi.aws.com", "allocatable": {"count": 1}}]}}


def case_csi_volume_limits():
    volumes = {
        "pvcs": [pvc("c1", sc="", volume_name="pv1"), pvc("c2", sc="", volume_name="pv2")],
        "pvs": [pv("pv1", claim_ref="c1", csi={"driver": "ebs.csi.aws.com", "volumeHandle": "h1"}),
                pv("pv2", claim_ref="c2", csi={"driver": "ebs.csi.aws.com", "volumeHandle": "h2"})],
        "csinodes": [_csinode("n1")],
    }
    _, a = run([node("n1"), node("n2")], [pod("p1", pvcs=["c1"]), pod("p2", pvcs=["c2"])],
               volumes, VOL)
    assert a[0][ann.SELECTED_NODE] != "" and a[1][ann.SELECTED_NODE] != ""
    if a[0][ann.SELECTED_NODE] == "n1":
        assert (filter_entry(a[1], "n1").get("NodeVolumeLimits")
                == nodevolumelimits.ERR_MAX_VOLUME_COUNT)
        assert a[1][ann.SELECTED_NODE] == "n2"


def case_same_volume_shared_counts_once():
    volumes = {
        "pvcs": [pvc("shared", sc="", volume_name="pv1", modes=("ReadWriteMany",))],
        "pvs": [pv("pv1", modes=("ReadWriteMany",), claim_ref="shared",
                   csi={"driver": "ebs.csi.aws.com", "volumeHandle": "h1"})],
        "csinodes": [_csinode("n1")],
    }
    _, a = run([node("n1")], [pod("p1", pvcs=["shared"]), pod("p2", pvcs=["shared"])],
               volumes, VOL)
    assert a[0][ann.SELECTED_NODE] == "n1" and a[1][ann.SELECTED_NODE] == "n1"


def case_bound_pod_wffc_claims_survive_recompile():
    volumes = {"pvcs": [pvc("c1", sc="wffc-sc"), pvc("c2", sc="wffc-sc")],
               "pvs": [pv("pv-only", sc="wffc-sc")],
               "storageclasses": [sc("wffc-sc", wffc=True, provisioner=NO_PROV)]}
    bound = [(pod("p1", pvcs=["c1"], node_name="n1"), "n1")]
    rr, a = run([node("n1")], [pod("p2", pvcs=["c2"])], volumes, VOL, bound=bound, chunk=1)
    assert filter_entry(a[0], "n1")["VolumeBinding"] == volumebinding.ERR_BIND_CONFLICT
    assert int(rr.selected[0]) == -1


def case_csi_limit_overfull_node_accepts_no_new_volume_pods():
    volumes = {
        "pvcs": [pvc("a", sc="", volume_name="pv-a"), pvc("b", sc="", volume_name="pv-b"),
                 pvc("shared", sc="", volume_name="pv-a", modes=("ReadWriteMany",))],
        "pvs": [pv("pv-a", modes=("ReadWriteMany",),
                   csi={"driver": "ebs.csi.aws.com", "volumeHandle": "h-a"}),
                pv("pv-b", csi={"driver": "ebs.csi.aws.com", "volumeHandle": "h-b"})],
        "csinodes": [_csinode("n1")],
    }
    bound = [(pod("pa", pvcs=["a"], node_name="n1"), "n1"),
             (pod("pb", pvcs=["b"], node_name="n1"), "n1")]
    rr, _ = run([node("n1")], [pod("p-reuse", pvcs=["shared"])], volumes, VOL, bound=bound,
                chunk=1)
    assert int(rr.selected[0]) == 0


def case_default_storageclass_applies_to_nil_class_pvc():
    volumes = {"pvcs": [pvc("c1")],
               "storageclasses": [sc("the-default", wffc=True, default=True)]}
    _, a = run([node("n1")], [pod("p1", pvcs=["c1"])], volumes, VOL)
    assert a[0][ann.SELECTED_NODE] == "n1"


def case_volume_plugins_in_default_config_parity():
    nodes = [node("n1", {"topology.kubernetes.io/zone": "east"}),
             node("n2", {"topology.kubernetes.io/zone": "west"}),
             node("n3", {"topology.kubernetes.io/zone": "east"})]
    volumes = {
        "pvcs": [pvc("bound-east", sc="", volume_name="pv-east"),
                 pvc("wffc-1", sc="wffc-sc"), pvc("wffc-2", sc="wffc-sc")],
        "pvs": [pv("pv-east", labels={"topology.kubernetes.io/zone": "east"},
                   node_affinity_hosts=["n1", "n3"], claim_ref="bound-east"),
                pv("pv-free", sc="wffc-sc", capacity="5Gi")],
        "storageclasses": [sc("wffc-sc", wffc=True, provisioner=NO_PROV)],
    }
    pods = [pod("p-zone", pvcs=["bound-east"]), pod("p-w1", pvcs=["wffc-1"]),
            pod("p-w2", pvcs=["wffc-2"]), pod("p-plain")]
    run(nodes, pods, volumes, None, chunk=2)


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_volume_case_matches_jax_and_oracle(name):
    CASES[name]()


def test_every_volume_test_has_a_case():
    """One case per test of tests/test_volumes.py, by name."""
    import test_volumes

    jax_tests = {n[len("test_"):] for n in dir(test_volumes) if n.startswith("test_")}
    assert jax_tests == set(CASES)
