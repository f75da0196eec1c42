"""Synthetic cluster / pod-queue generators for the BASELINE configs.

Port of kube_scheduler_simulator_tpu/models/workloads.py (`make_nodes`
:16, `make_pods` :68, `SLOT_LABEL` and `make_slot_pinned_workload`
:299-345, `BASELINE_CONFIGS` and `baseline_config` :481-524): the same
numpy draws in the same order, so the same seed gives the same manifests.
`make_gang_workload` ports :348, `make_nodes_columnar` :177,
`make_pods_columnar` :241 and `make_churn_workload` :406, the traffic
the port's soak (tools/soak.py) drives.
"""

from __future__ import annotations

import numpy as np

from ..plugins.registry import PluginSetConfig


def make_nodes(
    n: int,
    seed: int = 0,
    n_zones: int = 8,
    taint_fraction: float = 0.0,
    unschedulable_fraction: float = 0.0,
    cpu_milli: int = 64_000,
    mem_bytes: int = 256 << 30,
) -> list[dict]:
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n):
        cpu = int(cpu_milli * rng.choice([0.5, 1.0, 1.0, 2.0]))
        mem = int(mem_bytes * rng.choice([0.5, 1.0, 1.0, 2.0]))
        node = {
            "apiVersion": "v1",
            "kind": "Node",
            "metadata": {
                "name": f"node-{i:05d}",
                "labels": {
                    "kubernetes.io/hostname": f"node-{i:05d}",
                    "topology.kubernetes.io/zone": f"zone-{i % n_zones}",
                    "topology.kubernetes.io/region": f"region-{(i % n_zones) // 4}",
                    "node.kubernetes.io/instance-type": f"type-{int(rng.integers(4))}",
                    "disktype": "ssd" if rng.random() < 0.5 else "hdd",
                },
            },
            "spec": {},
            "status": {
                "allocatable": {
                    "cpu": f"{cpu}m",
                    "memory": str(mem),
                    "ephemeral-storage": str(512 << 30),
                    "pods": "110",
                },
                "conditions": [{"type": "Ready", "status": "True"}],
            },
        }
        if rng.random() < taint_fraction:
            node["spec"]["taints"] = [
                {"key": "dedicated", "value": "batch", "effect": "NoSchedule"}
            ]
        elif rng.random() < taint_fraction:
            node["spec"]["taints"] = [
                {"key": "degraded", "value": "", "effect": "PreferNoSchedule"}
            ]
        if rng.random() < unschedulable_fraction:
            node["spec"]["unschedulable"] = True
        nodes.append(node)
    return nodes


def make_pods(
    n: int,
    seed: int = 1,
    with_affinity: bool = False,
    with_tolerations: bool = False,
    with_spread: bool = False,
    with_interpod: bool = False,
    n_apps: int = 20,
) -> list[dict]:
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(n):
        app = f"app-{int(rng.integers(n_apps))}"
        cpu = int(rng.choice([100, 250, 500, 1000, 2000]))
        mem = int(rng.choice([128, 256, 512, 1024, 2048])) << 20
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": f"pod-{i:05d}",
                "namespace": "default",
                "labels": {"app": app, "tier": "web" if rng.random() < 0.5 else "backend"},
            },
            "spec": {
                "containers": [
                    {
                        "name": "main",
                        "image": "registry.k8s.io/pause:3.9",
                        "resources": {"requests": {"cpu": f"{cpu}m", "memory": str(mem)}},
                    }
                ],
            },
        }
        spec = pod["spec"]
        if with_affinity and rng.random() < 0.5:
            spec["affinity"] = {
                "nodeAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": {
                        "nodeSelectorTerms": [
                            {
                                "matchExpressions": [
                                    {"key": "disktype", "operator": "In", "values": ["ssd"]}
                                ]
                            }
                        ]
                    },
                    "preferredDuringSchedulingIgnoredDuringExecution": [
                        {
                            "weight": int(rng.integers(1, 100)),
                            "preference": {
                                "matchExpressions": [
                                    {
                                        "key": "node.kubernetes.io/instance-type",
                                        "operator": "In",
                                        "values": [f"type-{int(rng.integers(4))}"],
                                    }
                                ]
                            },
                        }
                    ],
                }
            }
        if with_tolerations and rng.random() < 0.3:
            spec["tolerations"] = [
                {"key": "dedicated", "operator": "Equal", "value": "batch", "effect": "NoSchedule"}
            ]
        if with_spread and rng.random() < 0.6:
            spec["topologySpreadConstraints"] = [
                {
                    "maxSkew": 5,
                    "topologyKey": "topology.kubernetes.io/zone",
                    "whenUnsatisfiable": "DoNotSchedule",
                    "labelSelector": {"matchLabels": {"app": app}},
                },
                {
                    "maxSkew": 3,
                    "topologyKey": "kubernetes.io/hostname",
                    "whenUnsatisfiable": "ScheduleAnyway",
                    "labelSelector": {"matchLabels": {"app": app}},
                },
            ]
        if with_interpod and rng.random() < 0.4:
            aff: dict = {}
            if rng.random() < 0.5:
                aff["podAffinity"] = {
                    "preferredDuringSchedulingIgnoredDuringExecution": [
                        {
                            "weight": int(rng.integers(1, 100)),
                            "podAffinityTerm": {
                                "topologyKey": "topology.kubernetes.io/zone",
                                "labelSelector": {"matchLabels": {"app": app}},
                            },
                        }
                    ]
                }
            else:
                aff["podAntiAffinity"] = {
                    "requiredDuringSchedulingIgnoredDuringExecution": [
                        {
                            "topologyKey": "kubernetes.io/hostname",
                            "labelSelector": {"matchLabels": {"app": app}},
                        }
                    ]
                }
            spec.setdefault("affinity", {}).update(aff)
        pods.append(pod)
    return pods


def make_nodes_columnar(
    n: int,
    seed: int = 0,
    n_zones: int = 8,
    taint_fraction: float = 0.0,
    unschedulable_fraction: float = 0.0,
    cpu_milli: int = 64_000,
    mem_bytes: int = 256 << 30,
):
    """Columnar fast path for make_nodes: the same node population shape
    (capacities, labels, taints) drawn with VECTORIZED rng — n nodes
    never exist as n dicts.  Draw streams differ from make_nodes for the
    same seed (per-row vs vectorized consumption), so a given scenario
    is either dict-generated or columnar-generated, not both; parity
    checks materialize THIS bank's rows to dicts and compare paths.
    -> ColumnarNodeBank (load via store.load_columnar or bank.view())."""
    from ..cluster.columnar import ColumnarNodeBank

    rng = np.random.default_rng(seed)
    bank = ColumnarNodeBank(capacity=max(n, 1))
    names = [f"node-{i:05d}" for i in range(n)]
    bank.bulk_rows(names)
    scale = rng.choice([0.5, 1.0, 1.0, 2.0], size=n)
    cpu = (cpu_milli * scale).astype(np.int64)
    mem = (mem_bytes * rng.choice([0.5, 1.0, 1.0, 2.0], size=n)).astype(np.int64)
    for rname, col in (("cpu", cpu), ("memory", mem),
                       ("ephemeral-storage",
                        np.full(n, 512 << 30, dtype=np.int64))):
        c, present = bank._res_col(rname)
        c[:n] = col
        present[:n] = True
    bank.allowed_pods[:n] = 110
    bank.rv[:n] = np.arange(1, n + 1)

    idx = np.arange(n)
    names_col = np.array(names, dtype=object)
    zone_pool = np.array([f"zone-{z}" for z in range(n_zones)], dtype=object)
    region_pool = np.array(
        [f"region-{z // 4}" for z in range(n_zones)], dtype=object)
    type_pool = np.array([f"type-{t}" for t in range(4)], dtype=object)
    bank.label_cols["kubernetes.io/hostname"] = names_col
    bank.label_cols["topology.kubernetes.io/zone"] = zone_pool[idx % n_zones]
    bank.label_cols["topology.kubernetes.io/region"] = region_pool[idx % n_zones]
    bank.label_cols["node.kubernetes.io/instance-type"] = \
        type_pool[rng.integers(4, size=n)]
    bank.label_cols["disktype"] = np.where(
        rng.random(n) < 0.5,
        np.array("ssd", dtype=object), np.array("hdd", dtype=object))

    if taint_fraction > 0:
        batch = [("dedicated", "batch", "NoSchedule")]
        degraded = [("degraded", "", "PreferNoSchedule")]
        t1 = rng.random(n) < taint_fraction
        t2 = rng.random(n) < taint_fraction
        taints = bank.taints
        for i in np.flatnonzero(t1):
            taints[i] = batch
        for i in np.flatnonzero(~t1 & t2):
            taints[i] = degraded
    if unschedulable_fraction > 0:
        bank.unschedulable[:n] = rng.random(n) < unschedulable_fraction
    return bank


def make_pods_columnar(
    n: int,
    seed: int = 1,
    with_affinity: bool = False,
    n_apps: int = 20,
):
    """Columnar fast path for make_pods (resource-request + label +
    required/preferred node-affinity shapes only — the spread/interpod
    variants stay dict-generated).  -> ColumnarPodBank."""
    from ..cluster.columnar import ColumnarPodBank

    rng = np.random.default_rng(seed)
    bank = ColumnarPodBank(capacity=max(n, 1))
    names = [f"default/pod-{i:05d}" for i in range(n)]
    bank.bulk_rows(names)
    cpu = rng.choice(np.array([100, 250, 500, 1000, 2000]), size=n)
    mem = rng.choice(np.array([128, 256, 512, 1024, 2048]), size=n) << 20
    bank._req_col("cpu")[:n] = cpu
    bank._req_col("memory")[:n] = mem
    bank.nonzero[:n, 0] = cpu
    bank.nonzero[:n, 1] = mem
    bank.rv[:n] = np.arange(1, n + 1)
    app_pool = np.array([f"app-{a}" for a in range(n_apps)], dtype=object)
    bank.label_cols["app"] = app_pool[rng.integers(n_apps, size=n)]
    bank.label_cols["tier"] = np.where(
        rng.random(n) < 0.5,
        np.array("web", dtype=object), np.array("backend", dtype=object))
    if with_affinity:
        # template space: preferred weight w in [1, 100) x instance type
        # t in [0, 4); code 0 = no affinity, else (w-1)*4 + t + 1
        templates = [
            {
                "nodeAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": {
                        "nodeSelectorTerms": [{
                            "matchExpressions": [{
                                "key": "disktype", "operator": "In",
                                "values": ["ssd"]}]
                        }]
                    },
                    "preferredDuringSchedulingIgnoredDuringExecution": [{
                        "weight": w,
                        "preference": {"matchExpressions": [{
                            "key": "node.kubernetes.io/instance-type",
                            "operator": "In", "values": [f"type-{t}"]}]},
                    }],
                }
            }
            for w in range(1, 100) for t in range(4)
        ]
        has = rng.random(n) < 0.5
        w = rng.integers(1, 100, size=n)
        t = rng.integers(4, size=n)
        codes = np.where(has, (w - 1) * 4 + t + 1, 0)
        bank.set_affinity_codes(codes, templates)
    return bank


SLOT_LABEL = "kss.simulator/slot"


def make_slot_pinned_workload(
    n_pods: int,
    n_nodes: int,
    seed: int = 0,
    slot_size: int = 2,
) -> tuple[list[dict], list[dict]]:
    """Reserved-slot fleet: nodes partition into slots of `slot_size` and
    every pod carries a REQUIRED nodeAffinity pin to one slot, the
    placement shape where each job owns a reserved node group.
    Feasibility is sparse (slot_size nodes per pod) and pods of different
    slots never interact, so the speculative wave's conflict oracle
    accepts whole batches: the low-contention scenario of the JAX
    package's `make bench-spec`.  -> (nodes, pods)."""
    nodes = make_nodes(n_nodes, seed=seed)
    n_slots = max(n_nodes // max(slot_size, 1), 1)
    for i, node in enumerate(nodes):
        node["metadata"]["labels"][SLOT_LABEL] = f"slot-{i % n_slots}"
    rng = np.random.default_rng(seed + 1)
    pods = []
    for i in range(n_pods):
        cpu = int(rng.choice([100, 250, 500]))
        pods.append({
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {"name": f"slot-pod-{i:05d}", "namespace": "default",
                         "labels": {"app": f"job-{i % n_slots}"}},
            "spec": {
                "containers": [{
                    "name": "main",
                    "image": "registry.k8s.io/pause:3.9",
                    "resources": {"requests": {"cpu": f"{cpu}m",
                                               "memory": str(256 << 20)}},
                }],
                "affinity": {"nodeAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": {
                        "nodeSelectorTerms": [{"matchExpressions": [{
                            "key": SLOT_LABEL, "operator": "In",
                            "values": [f"slot-{i % n_slots}"]}]}]}}},
            },
        })
    return nodes, pods

# BASELINE.md benchmark configs 1-5
def make_gang_workload(
    n_groups: int,
    members: int,
    min_member: int | None = None,
    seed: int = 0,
    namespace: str = "default",
    timeout_seconds: float = 30,
    cpu_milli: int = 500,
    mem_bytes: int = 512 << 20,
    name_prefix: str = "gang",
) -> tuple[list[dict], list[dict]]:
    """Deterministic gang workload: n_groups PodGroups of `members` pods
    each (minMember defaults to `members` — strict all-or-nothing), in
    the DL-training shape the papers care about (Tesserae / Gavel —
    PAPERS.md): every member requests identical resources and carries
    the ``scheduling.x-k8s.io/pod-group`` label.  -> (podgroups, pods).
    """
    from ..framework.gang import POD_GROUP_API_VERSION, POD_GROUP_LABEL

    rng = np.random.default_rng(seed)
    podgroups, pods = [], []
    for g in range(n_groups):
        gname = f"{name_prefix}-{g:04d}"
        podgroups.append({
            "apiVersion": POD_GROUP_API_VERSION,
            "kind": "PodGroup",
            "metadata": {"name": gname, "namespace": namespace},
            "spec": {
                "minMember": int(min_member if min_member is not None
                                 else members),
                "scheduleTimeoutSeconds": timeout_seconds,
            },
        })
        prio = int(rng.integers(0, 3)) * 100
        for m in range(members):
            pods.append({
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {
                    "name": f"{gname}-member-{m:03d}",
                    "namespace": namespace,
                    "labels": {POD_GROUP_LABEL: gname, "app": gname},
                },
                "spec": {
                    "priority": prio,
                    "containers": [{
                        "name": "trainer",
                        "image": "registry.k8s.io/pause:3.9",
                        "resources": {"requests": {
                            "cpu": f"{cpu_milli}m",
                            "memory": str(mem_bytes),
                        }},
                    }],
                },
            })
    return podgroups, pods


def make_churn_workload(
    n_nodes: int,
    ticks: int,
    seed: int = 0,
    arrival_rate: float = 20.0,
    departure_rate: float = 10.0,
    name_prefix: str = "churn",
    slot_size: int = 2,
) -> tuple[list[dict], list[dict]]:
    """Arrival-churn traffic over the reserved-slot fleet shape: a Poisson
    stream of pod arrivals plus Poisson departures of pods that arrived
    earlier, bucketed into `ticks` discrete steps.

    Deterministic for a (seed, shape) pair: one
    ``np.random.default_rng(seed + 1)`` draws the arrival counts, the
    departure counts and the departures in the JAX package's order, so the
    same arguments give the same schedule, byte for byte.  Departures only
    pick pods that arrived in an EARLIER tick and never pick twice, so a
    driver can create and delete in schedule order without bookkeeping.

    -> (nodes, schedule), schedule a list of per-tick dicts {"create":
    [pod manifests], "delete": [pod names]}.  Nodes carry SLOT_LABEL
    partitions and pods per-slot `app` labels, but the pods are not
    affinity-pinned: every wave then has the same compiled shape, which
    sustained-load drivers need."""
    nodes = make_nodes(n_nodes, seed=seed)
    n_slots = max(n_nodes // max(slot_size, 1), 1)
    for i, node in enumerate(nodes):
        node["metadata"]["labels"][SLOT_LABEL] = f"slot-{i % n_slots}"
    rng = np.random.default_rng(seed + 1)
    schedule: list[dict] = []
    live: list[str] = []   # arrival order; departures sample from here
    serial = 0
    for _t in range(max(ticks, 1)):
        n_arrive = int(rng.poisson(arrival_rate))
        n_depart = min(int(rng.poisson(departure_rate)), len(live))
        delete: list[str] = []
        if n_depart:
            picks = rng.choice(len(live), size=n_depart, replace=False)
            # pop from the back first so earlier indices stay valid
            for idx in sorted((int(p) for p in picks), reverse=True):
                delete.append(live.pop(idx))
            delete.reverse()
        create: list[dict] = []
        for _ in range(n_arrive):
            slot = int(rng.integers(n_slots))
            cpu = int(rng.choice([100, 250, 500]))
            name = f"{name_prefix}-pod-{serial:06d}"
            serial += 1
            create.append({
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {"name": name, "namespace": "default",
                             "labels": {"app": f"job-{slot}"}},
                "spec": {
                    "containers": [{
                        "name": "main",
                        "image": "registry.k8s.io/pause:3.9",
                        "resources": {"requests": {
                            "cpu": f"{cpu}m",
                            "memory": str(256 << 20)}},
                    }],
                },
            })
            live.append(name)
        schedule.append({"create": create, "delete": delete})
    return nodes, schedule


BASELINE_CONFIGS = {
    1: dict(pods=100, nodes=10, plugins=["NodeResourcesFit"]),
    2: dict(pods=1000, nodes=500, plugins=["NodeResourcesFit", "NodeResourcesBalancedAllocation"]),
    3: dict(
        pods=5000, nodes=1000,
        plugins=["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity", "TaintToleration"],
        affinity=True, tolerations=True, taint_fraction=0.1,
    ),
    4: dict(
        pods=10_000, nodes=5000,
        plugins=["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
                 "TaintToleration", "PodTopologySpread"],
        affinity=True, tolerations=True, taint_fraction=0.1, spread=True,
    ),
    5: dict(
        pods=10_000, nodes=5000,
        plugins=["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
                 "TaintToleration", "PodTopologySpread", "InterPodAffinity"],
        affinity=True, tolerations=True, taint_fraction=0.1, spread=True, interpod=True,
    ),
}


def baseline_config(idx: int, scale: float = 1.0, seed: int = 0,
                    node_scale: float | None = None):
    """-> (nodes, pods, PluginSetConfig). scale shrinks pod/node counts for
    tests and CPU-baseline measurement; node_scale (default: scale)
    overrides the node-axis factor separately — the CPU baseline keeps
    node_scale=1.0 so per-cycle cost reflects the real cluster size."""
    c = BASELINE_CONFIGS[idx]
    n_nodes = max(int(c["nodes"] * (scale if node_scale is None else node_scale)), 2)
    n_pods = max(int(c["pods"] * scale), 1)
    nodes = make_nodes(
        n_nodes, seed=seed,
        taint_fraction=c.get("taint_fraction", 0.0),
    )
    pods = make_pods(
        n_pods, seed=seed + 1,
        with_affinity=c.get("affinity", False),
        with_tolerations=c.get("tolerations", False),
        with_spread=c.get("spread", False),
        with_interpod=c.get("interpod", False),
    )
    return nodes, pods, PluginSetConfig(enabled=list(c["plugins"]))
