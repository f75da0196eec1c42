// Structured creation dialogs + scheduler-config plugin tuning.
//
// The reference UI offers per-resource creation dialogs (reference:
// web/components/ — PodDialog/NodeDialog/... with form fields feeding a
// manifest) on top of the raw YAML editor.  FORM_FIELDS declares each
// kind's fields; buildManifest folds the values into the template
// manifest, and the drawer's "Form" tab (app.js) renders/collects them.
// The plugin table edits profiles[0].plugins enable/disable + score
// weights structurally, the mergePluginSet surface the config rewrite
// implements server-side (scheduler/convert.py; reference:
// scheduler/plugin/plugins.go:230-304).
"use strict";

// field kinds: text, number, kvlines (key=value per line), lines (one
// item per line), select, check
const FORM_FIELDS = {
  pods: [
    ["name", "Name", "text", "demo-pod"],
    ["namespace", "Namespace", "text", "default"],
    ["image", "Container image", "text", "registry.k8s.io/pause:3.9"],
    ["cpu", "CPU request", "text", "100m"],
    ["memory", "Memory request", "text", "128Mi"],
    ["nodeSelector", "Node selector (k=v per line)", "kvlines", ""],
    ["priorityClassName", "Priority class", "text", ""],
    ["schedulerName", "Scheduler name", "text", ""],
    ["tolerations", "Tolerations (key=value:Effect per line)", "lines", ""],
  ],
  nodes: [
    ["name", "Name", "text", "node-demo"],
    ["cpu", "CPU capacity", "text", "4"],
    ["memory", "Memory capacity", "text", "8Gi"],
    ["podsCap", "Pods capacity", "text", "110"],
    ["labels", "Labels (k=v per line)", "kvlines",
     "topology.kubernetes.io/zone=zone-a"],
    ["taints", "Taints (key=value:Effect per line)", "lines", ""],
  ],
  namespaces: [
    ["name", "Name", "text", "team-a"],
    ["labels", "Labels (k=v per line)", "kvlines", ""],
  ],
  persistentvolumes: [
    ["name", "Name", "text", "pv-demo"],
    ["capacity", "Capacity", "text", "10Gi"],
    ["accessModes", "Access modes (one per line)", "lines", "ReadWriteOnce"],
    ["storageClassName", "Storage class", "text", "standard"],
  ],
  persistentvolumeclaims: [
    ["name", "Name", "text", "pvc-demo"],
    ["namespace", "Namespace", "text", "default"],
    ["request", "Requested storage", "text", "10Gi"],
    ["accessModes", "Access modes (one per line)", "lines", "ReadWriteOnce"],
    ["storageClassName", "Storage class", "text", "standard"],
  ],
  storageclasses: [
    ["name", "Name", "text", "standard"],
    ["provisioner", "Provisioner", "text", "kubernetes.io/no-provisioner"],
    ["volumeBindingMode", "Binding mode", "select",
     ["Immediate", "WaitForFirstConsumer"]],
  ],
  priorityclasses: [
    ["name", "Name", "text", "high-priority"],
    ["value", "Value", "number", "1000"],
    ["globalDefault", "Global default", "check", ""],
  ],
};

function parseKvLines(text) {
  const out = {};
  for (const line of (text || "").split("\n")) {
    const t = line.trim();
    if (!t) continue;
    const i = t.indexOf("=");
    if (i > 0) out[t.slice(0, i)] = t.slice(i + 1);
  }
  return out;
}

function parseTaintLines(text) {
  // key=value:Effect | key:Effect  (value optional, like kubectl taint)
  const out = [];
  for (const line of (text || "").split("\n")) {
    const t = line.trim();
    if (!t) continue;
    const ci = t.lastIndexOf(":");
    const effect = ci >= 0 ? t.slice(ci + 1) : "NoSchedule";
    const kv = ci >= 0 ? t.slice(0, ci) : t;
    const ei = kv.indexOf("=");
    const taint = ei > 0
      ? { key: kv.slice(0, ei), value: kv.slice(ei + 1), effect }
      : { key: kv, effect };
    out.push(taint);
  }
  return out;
}

function parseLines(text) {
  return (text || "").split("\n").map((l) => l.trim()).filter(Boolean);
}

// form values -> manifest, starting from the kind's template
function buildManifest(resource, v) {
  const obj = JSON.parse(JSON.stringify(TEMPLATES[resource]));
  obj.metadata = obj.metadata || {};
  obj.metadata.name = v.name || obj.metadata.name;
  if ("labels" in v) {
    const labels = parseKvLines(v.labels);
    if (Object.keys(labels).length) obj.metadata.labels = labels;
    else delete obj.metadata.labels;
  }
  if (resource === "pods") {
    obj.metadata.namespace = v.namespace || "default";
    const spec = (obj.spec = obj.spec || {});
    const c0 = ((spec.containers = spec.containers || [{}]))[0];
    c0.name = c0.name || "c";
    if (v.image) c0.image = v.image;
    c0.resources = { requests: {} };
    if (v.cpu) c0.resources.requests.cpu = v.cpu;
    if (v.memory) c0.resources.requests.memory = v.memory;
    if (!Object.keys(c0.resources.requests).length) delete c0.resources;
    const sel = parseKvLines(v.nodeSelector);
    if (Object.keys(sel).length) spec.nodeSelector = sel;
    if (v.priorityClassName) spec.priorityClassName = v.priorityClassName;
    if (v.schedulerName) spec.schedulerName = v.schedulerName;
    const tol = parseTaintLines(v.tolerations).map((t) => (
      t.value !== undefined
        ? { key: t.key, operator: "Equal", value: t.value, effect: t.effect }
        : { key: t.key, operator: "Exists", effect: t.effect }));
    if (tol.length) spec.tolerations = tol;
  } else if (resource === "nodes") {
    const caps = {};
    if (v.cpu) caps.cpu = v.cpu;
    if (v.memory) caps.memory = v.memory;
    if (v.podsCap) caps.pods = v.podsCap;
    obj.status = obj.status || {};
    obj.status.capacity = Object.assign({}, obj.status.capacity, caps);
    obj.status.allocatable = Object.assign({}, obj.status.allocatable, caps);
    const taints = parseTaintLines(v.taints);
    if (taints.length) (obj.spec = obj.spec || {}).taints = taints;
  } else if (resource === "persistentvolumes") {
    const spec = (obj.spec = obj.spec || {});
    if (v.capacity) spec.capacity = { storage: v.capacity };
    const am = parseLines(v.accessModes);
    if (am.length) spec.accessModes = am;
    if (v.storageClassName) spec.storageClassName = v.storageClassName;
  } else if (resource === "persistentvolumeclaims") {
    obj.metadata.namespace = v.namespace || "default";
    const spec = (obj.spec = obj.spec || {});
    if (v.request) spec.resources = { requests: { storage: v.request } };
    const am = parseLines(v.accessModes);
    if (am.length) spec.accessModes = am;
    if (v.storageClassName) spec.storageClassName = v.storageClassName;
  } else if (resource === "storageclasses") {
    if (v.provisioner) obj.provisioner = v.provisioner;
    if (v.volumeBindingMode) obj.volumeBindingMode = v.volumeBindingMode;
  } else if (resource === "priorityclasses") {
    if (v.value !== "" && v.value !== undefined) obj.value = +v.value;
    obj.globalDefault = !!v.globalDefault;
  }
  return obj;
}

function formHtml(resource, saved) {
  // saved: previously collected values (tab round-trips must not discard
  // the user's input); defaults otherwise
  const fields = FORM_FIELDS[resource] || [];
  saved = saved || {};
  return `<div class="formgrid">` + fields.map(([id, label, kind, dflt]) => {
    const fid = `ff_${id}`;
    const val = id in saved ? saved[id] : (kind === "select" ? "" : dflt);
    let input;
    if (kind === "kvlines" || kind === "lines")
      input = `<textarea id="${fid}" rows="3" spellcheck="false">${esc(val)}</textarea>`;
    else if (kind === "select")
      input = `<select id="${fid}">${dflt.map((o) =>
        `<option ${saved[id] === o ? "selected" : ""}>${esc(o)}</option>`).join("")}</select>`;
    else if (kind === "check")
      input = `<input type="checkbox" id="${fid}" ${val ? "checked" : ""}>`;
    else
      input = `<input type="${kind === "number" ? "number" : "text"}" id="${fid}" value="${esc(val)}">`;
    return `<label for="${fid}">${esc(label)}</label>${input}`;
  }).join("") + `</div>`;
}

function collectForm(resource) {
  const v = {};
  for (const [id, , kind] of FORM_FIELDS[resource] || []) {
    const el = document.getElementById(`ff_${id}`);
    if (!el) continue;
    v[id] = kind === "check" ? el.checked : el.value;
  }
  return v;
}

// ---- scheduler-config plugin table --------------------------------------
// default lineup + weights mirror plugins/registry.py (upstream v1.32
// getDefaultPlugins); the table writes profiles[0].plugins.{filter,score}
// enabled/disabled sets the way the server's convert path consumes them.
const PLUGIN_TABLE = [
  // [name, hasFilter, hasScore, defaultWeight]
  ["SchedulingGates", false, false, 0],
  ["NodeUnschedulable", true, false, 0],
  ["NodeName", true, false, 0],
  ["TaintToleration", true, true, 3],
  ["NodeAffinity", true, true, 2],
  ["NodePorts", true, false, 0],
  ["NodeResourcesFit", true, true, 1],
  ["VolumeRestrictions", true, false, 0],
  ["NodeVolumeLimits", true, false, 0],
  ["VolumeBinding", true, true, 1],
  ["VolumeZone", true, false, 0],
  ["PodTopologySpread", true, true, 2],
  ["InterPodAffinity", true, true, 2],
  ["DefaultPreemption", false, false, 0],
  ["NodeResourcesBalancedAllocation", false, true, 1],
  ["ImageLocality", false, true, 1],
];

function pluginStateFromConfig(cfg) {
  // {name: {enabled, weight}} from profiles[0].plugins: a multiPoint
  // wildcard disable flips the default to "enabled only if listed";
  // otherwise any per-point disable shows the plugin off
  const state = {};
  const plugins = (((cfg || {}).profiles || [])[0] || {}).plugins || {};
  const mp = plugins.multiPoint || {};
  const wildcardOff = (mp.disabled || []).some((d) => d.name === "*");
  const mpEnabled = new Set((mp.enabled || []).map((e) => e.name));
  const disabledNames = new Set();
  for (const point of Object.values(plugins))
    for (const d of (point || {}).disabled || [])
      if (d.name && d.name !== "*") disabledNames.add(d.name);
  for (const [name, , , w] of PLUGIN_TABLE)
    state[name] = {
      enabled: wildcardOff ? mpEnabled.has(name) : !disabledNames.has(name),
      weight: w,
    };
  for (const point of ["multiPoint", "score"])
    for (const e of ((plugins[point] || {}).enabled) || [])
      if (state[e.name] && e.weight) state[e.name].weight = e.weight;
  return state;
}

// apply only the DIFF vs `initial` (the state the table was rendered
// from), so an untouched Apply is a no-op on the manifest: existing
// wildcard disables, per-point entries, and hand-written plugin config
// all survive.
function applyPluginStateToConfig(cfg, state, initial) {
  cfg = cfg || {};
  const profiles = (cfg.profiles = cfg.profiles && cfg.profiles.length
    ? cfg.profiles : [{ schedulerName: "default-scheduler" }]);
  const plugins = (profiles[0].plugins = profiles[0].plugins || {});
  const mp = (plugins.multiPoint = plugins.multiPoint || {});
  const wildcardOff = (mp.disabled || []).some((d) => d.name === "*");
  for (const [name, , hasScore] of PLUGIN_TABLE) {
    const st = state[name], init = (initial || {})[name] || {};
    if (!st) continue;
    if (st.enabled !== init.enabled) {
      if (!st.enabled) {
        // disable: drop from every enabled list, add a multiPoint disable
        for (const point of Object.values(plugins))
          if (point && point.enabled)
            point.enabled = point.enabled.filter((e) => e.name !== name);
        if (!wildcardOff && !(mp.disabled || []).some((d) => d.name === name))
          (mp.disabled = mp.disabled || []).push({ name });
      } else {
        // enable: drop per-point disables; under a wildcard, list it
        for (const point of Object.values(plugins))
          if (point && point.disabled)
            point.disabled = point.disabled.filter((d) => d.name !== name);
        if (wildcardOff && !(mp.enabled || []).some((e) => e.name === name))
          (mp.enabled = mp.enabled || []).push({ name });
      }
    }
    if (hasScore && st.enabled && +st.weight !== +init.weight) {
      // weight change: upsert into score.enabled (getScorePluginWeight
      // reads weights from the enabled entries; plugins.go:289-304)
      const sc = (plugins.score = plugins.score || {});
      const entry = (sc.enabled = sc.enabled || [])
        .find((e) => e.name === name);
      if (entry) entry.weight = +st.weight;
      else sc.enabled.push({ name, weight: +st.weight });
    }
  }
  return cfg;
}

function pluginTableHtml(state) {
  return `<table class="plugtable"><thead><tr>
      <th>Plugin</th><th>Enabled</th><th>Filter</th><th>Score</th>
      <th>Weight</th></tr></thead><tbody>` +
    PLUGIN_TABLE.map(([name, hasF, hasS]) => {
      const st = state[name];
      return `<tr>
        <td>${esc(name)}</td>
        <td><input type="checkbox" data-plug="${esc(name)}"
             ${st.enabled ? "checked" : ""}></td>
        <td>${hasF ? "●" : ""}</td><td>${hasS ? "●" : ""}</td>
        <td>${hasS ? `<input type="number" min="0" style="width:64px"
             data-plugw="${esc(name)}" value="${st.weight}"
             ${st.enabled ? "" : "disabled"}>` : ""}</td></tr>`;
    }).join("") + `</tbody></table>`;
}

function collectPluginTable(root, state) {
  for (const cb of root.querySelectorAll("input[data-plug]"))
    state[cb.dataset.plug].enabled = cb.checked;
  for (const w of root.querySelectorAll("input[data-plugw]"))
    state[w.dataset.plugw].weight = +w.value || 0;
  return state;
}
