// Per-resource reactive stores — the web/store/*.ts analogue of the
// reference UI (one store per kind holding the live object map, fed by
// the watch stream; views subscribe and re-render on change).
"use strict";

const KINDS = [
  ["pods", "Pods", true],
  ["nodes", "Nodes", false],
  ["persistentvolumes", "PersistentVolumes", false],
  ["persistentvolumeclaims", "PersistentVolumeClaims", true],
  ["storageclasses", "StorageClasses", false],
  ["priorityclasses", "PriorityClasses", false],
  ["namespaces", "Namespaces", false],
];
const KIND_BY_WATCH = {
  Pod: "pods", Node: "nodes", PersistentVolume: "persistentvolumes",
  PersistentVolumeClaim: "persistentvolumeclaims",
  StorageClass: "storageclasses", PriorityClass: "priorityclasses",
  Namespace: "namespaces",
};

const keyOf = (o) =>
  (o.metadata.namespace ? o.metadata.namespace + "/" : "") + o.metadata.name;

class ResourceStore {
  constructor(resource, namespaced) {
    this.resource = resource;
    this.namespaced = namespaced;
    this.items = new Map();
    this.subs = new Set();
  }

  apply(eventType, obj) {
    const k = keyOf(obj);
    if (eventType === "DELETED") this.items.delete(k);
    else this.items.set(k, obj);
  }

  get(key) { return this.items.get(key); }
  get size() { return this.items.size; }

  all() { return [...this.items.values()]; }

  namespaces() {
    const out = new Set();
    for (const o of this.items.values()) out.add(o.metadata.namespace || "default");
    return [...out].sort();
  }

  filtered(query, namespace) {
    let rows = this.all();
    if (namespace) {
      rows = rows.filter((o) => (o.metadata.namespace || "default") === namespace);
    }
    if (query) {
      const q = query.toLowerCase();
      rows = rows.filter((o) => JSON.stringify(o).toLowerCase().includes(q));
    }
    return rows;
  }

  subscribe(fn) { this.subs.add(fn); return () => this.subs.delete(fn); }
  notify() { for (const fn of this.subs) fn(this); }
}

const STORES = {};
for (const [r, , namespaced] of KINDS) STORES[r] = new ResourceStore(r, namespaced);

const dirtyStores = new Set();
function handleWatchEvent(ev) {
  const r = KIND_BY_WATCH[ev.kind];
  if (!r) return;
  STORES[r].apply(ev.eventType, ev.obj);
  dirtyStores.add(r);
}
function flushStores() {
  for (const r of dirtyStores) STORES[r].notify();
  dirtyStores.clear();
}
function resetStores() {
  for (const [r] of KINDS) { STORES[r].items.clear(); dirtyStores.add(r); }
  flushStores();
}

// ---- k8s quantity helpers (for request/capacity columns) ---------------
const Q_SUFFIX = {
  n: 1e-9, u: 1e-6, m: 1e-3, "": 1, k: 1e3, M: 1e6, G: 1e9, T: 1e12,
  Ki: 1024, Mi: 1024 ** 2, Gi: 1024 ** 3, Ti: 1024 ** 4,
};
function parseQuantity(s) {
  if (s === undefined || s === null) return 0;
  const m = String(s).match(/^([0-9.]+)([A-Za-z]*)$/);
  if (!m) return 0;
  return parseFloat(m[1]) * (Q_SUFFIX[m[2]] !== undefined ? Q_SUFFIX[m[2]] : 1);
}
function podRequests(pod) {
  const total = { cpu: 0, memory: 0 };
  for (const c of ((pod.spec || {}).containers || [])) {
    const req = ((c.resources || {}).requests) || {};
    total.cpu += parseQuantity(req.cpu);
    total.memory += parseQuantity(req.memory);
  }
  return total;
}
function fmtCpu(v) { return v >= 1 ? (+v.toFixed(2)) + "" : Math.round(v * 1000) + "m"; }
function fmtMem(v) {
  if (!v) return "0";
  if (v >= 1024 ** 3) return (v / 1024 ** 3).toFixed(1).replace(/\.0$/, "") + "Gi";
  if (v >= 1024 ** 2) return Math.round(v / 1024 ** 2) + "Mi";
  return Math.round(v / 1024) + "Ki";
}
