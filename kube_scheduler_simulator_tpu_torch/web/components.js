// View components — the web/components/*.vue analogue of the reference UI
// (resource tables and list views, the YAML manifest editor, and the
// scheduling-result tables built from the Pod's result annotations, as
// web/components/lib/util.ts:30-44 converts them).
"use strict";

const ANN = "kube-scheduler-simulator.sigs.k8s.io/";
const RESULT_KEYS = [ // annotation.go:3-30 + extender keys
  "prefilter-result-status", "prefilter-result", "filter-result",
  "postfilter-result", "prescore-result", "score-result", "finalscore-result",
  "reserve-result", "permit-result", "permit-result-timeout", "prebind-result",
  "bind-result", "extender-filter-result", "extender-prioritize-result",
  "extender-preempt-result", "extender-bind-result",
];

const TEMPLATES = {
  pods: { kind: "Pod", apiVersion: "v1",
    metadata: { name: "pod-1", namespace: "default" },
    spec: { containers: [{ name: "c", image: "nginx",
      resources: { requests: { cpu: "500m", memory: "512Mi" } } }] } },
  nodes: { kind: "Node", apiVersion: "v1", metadata: { name: "node-1" },
    status: { allocatable: { cpu: "8", memory: "32Gi", pods: "110" },
      capacity: { cpu: "8", memory: "32Gi", pods: "110" } } },
  persistentvolumes: { kind: "PersistentVolume", apiVersion: "v1",
    metadata: { name: "pv-1" },
    spec: { capacity: { storage: "1Gi" }, accessModes: ["ReadWriteOnce"] } },
  persistentvolumeclaims: { kind: "PersistentVolumeClaim", apiVersion: "v1",
    metadata: { name: "pvc-1", namespace: "default" },
    spec: { accessModes: ["ReadWriteOnce"],
      resources: { requests: { storage: "1Gi" } } } },
  storageclasses: { kind: "StorageClass", apiVersion: "storage.k8s.io/v1",
    metadata: { name: "sc-1" }, provisioner: "kubernetes.io/no-provisioner" },
  priorityclasses: { kind: "PriorityClass", apiVersion: "scheduling.k8s.io/v1",
    metadata: { name: "pc-1" }, value: 1000 },
  namespaces: { kind: "Namespace", apiVersion: "v1",
    metadata: { name: "ns-1" } },
};

const ESC_RE = new RegExp('[&<>"\']', "g");
function esc(s) {
  return String(s).replace(ESC_RE, (c) => (
    { "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;" }[c]));
}

// per-render derived data for column getters (recomputed once per
// renderList, never inside a sort comparator)
const COLUMN_CTX = { podCounts: new Map() };

// ---- per-kind table columns (reference: web/components/<Kind>List.vue) --
const COLUMNS = {
  pods: [
    ["Name", (o) => o.metadata.name],
    ["Namespace", (o) => o.metadata.namespace || "default"],
    ["Node", (o) => (o.spec || {}).nodeName || ""],
    ["Status", (o) => podPhase(o), (o) => `<span class="pill ${podPhase(o) === "Scheduled" ? "ok" : ""}">${esc(podPhase(o))}</span>`],
    ["CPU req", (o) => podRequests(o).cpu, (o) => esc(fmtCpu(podRequests(o).cpu))],
    ["Mem req", (o) => podRequests(o).memory, (o) => esc(fmtMem(podRequests(o).memory))],
    ["Priority", (o) => (o.spec || {}).priority || 0],
  ],
  nodes: [
    ["Name", (o) => o.metadata.name],
    ["CPU", (o) => parseQuantity(((o.status || {}).allocatable || {}).cpu),
      (o) => esc(((o.status || {}).allocatable || {}).cpu || "")],
    ["Memory", (o) => parseQuantity(((o.status || {}).allocatable || {}).memory),
      (o) => esc(((o.status || {}).allocatable || {}).memory || "")],
    ["Pods cap", (o) => +(((o.status || {}).allocatable || {}).pods || 0)],
    ["Pods", (o) => COLUMN_CTX.podCounts.get(o.metadata.name) || 0],
    ["Taints", (o) => (((o.spec || {}).taints) || []).length],
    ["Labels", (o) => Object.keys((o.metadata.labels || {})).length],
  ],
  persistentvolumes: [
    ["Name", (o) => o.metadata.name],
    ["Capacity", (o) => parseQuantity((((o.spec || {}).capacity) || {}).storage),
      (o) => esc((((o.spec || {}).capacity) || {}).storage || "")],
    ["Access", (o) => (((o.spec || {}).accessModes) || []).join(",")],
    ["Claim", (o) => { const c = (o.spec || {}).claimRef; return c ? (c.namespace || "") + "/" + (c.name || "") : ""; }],
    ["Status", (o) => ((o.status || {}).phase) || ""],
  ],
  persistentvolumeclaims: [
    ["Name", (o) => o.metadata.name],
    ["Namespace", (o) => o.metadata.namespace || "default"],
    ["Request", (o) => parseQuantity(((((o.spec || {}).resources) || {}).requests || {}).storage),
      (o) => esc(((((o.spec || {}).resources) || {}).requests || {}).storage || "")],
    ["Volume", (o) => ((o.spec || {}).volumeName) || ""],
    ["Status", (o) => ((o.status || {}).phase) || ""],
  ],
  storageclasses: [
    ["Name", (o) => o.metadata.name],
    ["Provisioner", (o) => o.provisioner || ""],
    ["Binding mode", (o) => o.volumeBindingMode || "Immediate"],
  ],
  priorityclasses: [
    ["Name", (o) => o.metadata.name],
    ["Value", (o) => o.value || 0],
    ["Global default", (o) => o.globalDefault ? "yes" : ""],
  ],
  namespaces: [
    ["Name", (o) => o.metadata.name],
    ["Status", (o) => ((o.status || {}).phase) || "Active"],
  ],
};

function podPhase(o) {
  if ((o.spec || {}).nodeName) return "Scheduled";
  const conds = ((o.status || {}).conditions) || [];
  const sched = conds.find((c) => c.type === "PodScheduled");
  if (sched && sched.reason === "Unschedulable") return "Unschedulable";
  if (sched && sched.reason === "SchedulingGated") return "Gated";
  return (o.status || {}).phase || "Pending";
}

// ---- resource list view -------------------------------------------------
function renderList(el, state) {
  if (state.view === "schedulerconfig") return renderSchedulerConfig(el);
  if (state.view === "scenarios") return renderScenarios(el);
  const [r, label] = KINDS.find(([k]) => k === state.view);
  const store = STORES[r];
  const cols = COLUMNS[r];
  if (r === "nodes") {
    COLUMN_CTX.podCounts = new Map();
    for (const p of STORES.pods.items.values()) {
      const nn = (p.spec || {}).nodeName;
      if (nn) COLUMN_CTX.podCounts.set(nn, (COLUMN_CTX.podCounts.get(nn) || 0) + 1);
    }
  }
  const ui = state.listUI[r] || (state.listUI[r] = { sort: 0, dir: 1, q: "", ns: "" });
  let rows = store.filtered(ui.q, ui.ns);
  const sortCol = cols[ui.sort];
  rows.sort((a, b) => {
    const va = sortCol[1](a), vb = sortCol[1](b);
    return (va < vb ? -1 : va > vb ? 1 : 0) * ui.dir;
  });
  const nsOptions = store.namespaced
    ? `<select id="nsFilter">
        <option value="">all namespaces</option>
        ${store.namespaces().map((n) =>
          `<option ${ui.ns === n ? "selected" : ""}>${esc(n)}</option>`).join("")}
      </select>` : "";
  el.innerHTML = `
    <div class="toolbar"><h2>${label}</h2>
      <input id="searchBox" type="search" placeholder="filter…" value="${esc(ui.q)}">
      ${nsOptions}
      <button class="primary" data-new="${r}">New</button></div>
    <table><thead><tr>
      ${cols.map(([name], i) =>
        `<th class="sortable" data-col="${i}">${esc(name)}${ui.sort === i ? (ui.dir > 0 ? " ▲" : " ▼") : ""}</th>`).join("")}
    </tr></thead><tbody>
    ${rows.map((o) => `<tr class="row" data-res="${r}" data-key="${esc(keyOf(o))}">
      ${cols.map((c) => `<td>${c[2] ? c[2](o) : esc(c[1](o))}</td>`).join("")}
    </tr>`).join("")}
    </tbody></table>
    ${rows.length ? `<p class="kv">${rows.length} of ${store.size}</p>`
                  : '<p class="kv">No resources. The watch stream fills this live.</p>'}`;
  const sb = el.querySelector("#searchBox");
  sb.addEventListener("input", () => { ui.q = sb.value; renderList(el, state); });
  if (ui.q) { sb.focus(); sb.setSelectionRange(sb.value.length, sb.value.length); }
  const nf = el.querySelector("#nsFilter");
  if (nf) nf.addEventListener("change", () => { ui.ns = nf.value; renderList(el, state); });
  el.querySelectorAll("th.sortable").forEach((th) => th.addEventListener("click", () => {
    const col = +th.dataset.col;
    if (ui.sort === col) ui.dir = -ui.dir; else { ui.sort = col; ui.dir = 1; }
    renderList(el, state);
  }));
}

// ---- manifest editor (monaco-YAML analogue: highlighted, line-numbered) -
function editorHtml(id) {
  return `<div class="edwrap">
    <pre class="edlines" id="${id}Lines">1</pre>
    <div class="edstack">
      <pre class="edhl" id="${id}Hl"></pre>
      <textarea id="${id}" spellcheck="false"></textarea>
    </div>
  </div>`;
}
function hookEditor(id) {
  const ta = document.getElementById(id);
  const hl = document.getElementById(id + "Hl");
  const ln = document.getElementById(id + "Lines");
  const refresh = () => {
    const lines = ta.value.split("\n").length;
    ln.textContent = Array.from({ length: lines }, (_, i) => i + 1).join("\n");
    hl.innerHTML = highlightYaml(ta.value);
    hl.scrollTop = ta.scrollTop; ln.scrollTop = ta.scrollTop;
  };
  ta.addEventListener("input", refresh);
  ta.addEventListener("scroll", () => { hl.scrollTop = ta.scrollTop; ln.scrollTop = ta.scrollTop; });
  ta._refresh = refresh;
  return ta;
}
function setEditorValue(id, text) {
  const ta = document.getElementById(id);
  ta.value = text;
  if (ta._refresh) ta._refresh();
}
function highlightYaml(text) {
  return text.split("\n").map((line) => {
    const m = line.match(/^(\s*-?\s*)("(?:[^"\\]|\\.)*"|[\w.\/-]+)(:)(.*)$/);
    if (m) {
      return esc(m[1]) + '<span class="y-key">' + esc(m[2]) + "</span>" + esc(m[3]) +
        '<span class="y-val">' + esc(m[4]) + "</span>";
    }
    if (/^\s*#/.test(line)) return '<span class="y-com">' + esc(line) + "</span>";
    return '<span class="y-val">' + esc(line) + "</span>";
  }).join("\n");
}

// ---- scheduling result tables (util.ts:30-44 analogue) ------------------
function resultTable(parsed, selectedNode) {
  const plugins = [...new Set(Object.values(parsed).flatMap((v) => Object.keys(v)))].sort();
  if (!plugins.length) return "";
  const nodes = Object.keys(parsed).sort();
  return `<div class="resultwrap"><table><thead><tr><th>Node</th>
    ${plugins.map((p) => `<th>${esc(p)}</th>`).join("")}</tr></thead><tbody>
    ${nodes.map((n) => `<tr class="${n === selectedNode ? "selrow" : ""}"><td>${esc(n)}</td>
      ${plugins.map((p) => `<td>${esc(parsed[n][p] === undefined ? "" : parsed[n][p])}</td>`).join("")}
    </tr>`).join("")}</tbody></table></div>`;
}

function renderResults(pod) {
  const anns = (pod.metadata && pod.metadata.annotations) || {};
  let html = "";
  const sel = anns[ANN + "selected-node"];
  html += `<h3 class="sect">selected-node</h3><p>${sel ? `<span class="pill ok">${esc(sel)}</span>` : "<i>not scheduled yet</i>"}</p>`;
  // finalscore summary: winner per weighted total (what selectHost used)
  const finalRaw = anns[ANN + "finalscore-result"];
  if (finalRaw && finalRaw !== "{}") {
    try {
      const fin = JSON.parse(finalRaw);
      const totals = Object.entries(fin).map(([n, m]) =>
        [n, Object.values(m).reduce((a, v) => a + (+v || 0), 0)]);
      totals.sort((a, b) => b[1] - a[1]);
      if (totals.length) {
        html += `<p class="kv">highest weighted total: <b>${esc(totals[0][0])}</b>
          (${totals[0][1]})${totals.length > 1 ? `, runner-up ${esc(totals[1][0])} (${totals[1][1]})` : ""}</p>`;
      }
    } catch (e) { /* not a table */ }
  }
  html += renderResultSet(anns, sel, "h3");
  const hist = anns[ANN + "result-history"];
  if (hist) {
    try {
      const records = JSON.parse(hist);
      html += `<h3 class="sect">result-history</h3><p class="kv">${records.length} record(s)</p>`;
      records.forEach((rec, i) => {
        const recSel = rec[ANN + "selected-node"];
        const body = renderResultSet(rec, recSel, "h4");
        html += `<details class="hist"><summary>cycle ${i + 1}${recSel ? ` — selected ${esc(recSel)}` : ""}</summary>${body}</details>`;
      });
    } catch (e) { /* ignore */ }
  }
  return html;
}

function renderResultSet(source, selNode, headingTag) {
  // one RESULT_KEYS pass shared by the live annotations and each
  // result-history record
  let html = "";
  for (const key of RESULT_KEYS) {
    const raw = source[ANN + key];
    if (!raw || raw === "{}" || raw === "null") continue;
    let parsed;
    try { parsed = JSON.parse(raw); } catch (e) { parsed = null; }
    html += `<${headingTag} class="sect">${esc(key)}</${headingTag}>`;
    if (parsed && typeof parsed === "object" && !Array.isArray(parsed) &&
        Object.values(parsed).every((v) => v && typeof v === "object" && !Array.isArray(v))) {
      html += resultTable(parsed, selNode);
    } else {
      html += `<pre class="kv">${esc(JSON.stringify(parsed === null ? raw : parsed, null, 2))}</pre>`;
    }
  }
  return html;
}

// ---- scheduler config + scenarios panels --------------------------------
async function renderSchedulerConfig(el) {
  el.innerHTML = `<div class="toolbar"><h2>Scheduler Configuration</h2>
      <span class="kv">format</span>
      <select id="cfgFmt"><option>yaml</option><option>json</option></select>
      <button class="primary" id="cfgApply">Apply</button></div>
    <h3 class="sect">plugins (structured — folded into the manifest on Apply)</h3>
    <div id="plugPanel"></div>
    <h3 class="sect">manifest</h3>
    ${editorHtml("schedCfg")}<div id="cfgMsg" class="msg"></div>
    <p class="kv">POST applies profiles + extenders and restarts the scheduler
      (handler/schedulerconfig.go:41-63 semantics).</p>`;
  hookEditor("schedCfg");
  let fmt = "yaml";
  let cfg = null;
  let plugState = null;
  const plugPanel = document.getElementById("plugPanel");
  try {
    cfg = await API.getSchedulerConfig();
    setEditorValue("schedCfg", YAML.dump(cfg));
    plugState = pluginStateFromConfig(cfg);
    plugPanel.innerHTML = pluginTableHtml(plugState);
    plugPanel.addEventListener("change", (ev) => {
      const cb = ev.target.closest("input[data-plug]");
      if (!cb) return;
      // keep the weight cell's enabled state in step with the checkbox
      const w = plugPanel.querySelector(
        `input[data-plugw="${cb.dataset.plug}"]`);
      if (w) w.disabled = !cb.checked;
    });
  } catch (e) { document.getElementById("cfgMsg").textContent = e.message; }
  document.getElementById("cfgFmt").addEventListener("change", (ev) => {
    const msg = document.getElementById("cfgMsg");
    try {
      const cur = document.getElementById("schedCfg").value;
      const obj = fmt === "yaml" ? YAML.parse(cur) : JSON.parse(cur);
      fmt = ev.target.value;
      setEditorValue("schedCfg", fmt === "yaml" ? YAML.dump(obj) : JSON.stringify(obj, null, 2));
      msg.textContent = "";
    } catch (e) { msg.className = "msg err"; msg.textContent = e.message; }
  });
  document.getElementById("cfgApply").addEventListener("click", async () => {
    const msg = document.getElementById("cfgMsg");
    try {
      const cur = document.getElementById("schedCfg").value;
      let obj = fmt === "yaml" ? YAML.parse(cur) : JSON.parse(cur);
      if (plugState) {
        // only the DIFF vs the rendered state is folded in — an
        // untouched table leaves wildcard/per-point plugin config alone
        const initial = pluginStateFromConfig(obj);
        collectPluginTable(plugPanel, plugState);
        obj = applyPluginStateToConfig(obj, plugState, initial);
        setEditorValue("schedCfg", fmt === "yaml"
          ? YAML.dump(obj) : JSON.stringify(obj, null, 2));
      }
      await API.applySchedulerConfig(obj);
      msg.className = "msg ok"; msg.textContent = "applied (scheduler restarted)";
    } catch (e) { msg.className = "msg err"; msg.textContent = e.message; }
  });
}

async function renderScenarios(el) {
  let items = [];
  try { items = (await API.scenarios()).items; } catch (e) { /* server may lack it */ }
  el.innerHTML = `<div class="toolbar"><h2>Scenarios (KEP-140)</h2>
      <button id="scenRefresh">Refresh</button></div>
    <table><thead><tr><th>Name</th><th>Phase</th><th>Step</th><th>Timeline events</th></tr></thead>
    <tbody>${items.map((s) => {
      const st = s.status || {}, step = (st.stepStatus || {}).step || {};
      const tl = ((st.scenarioResult || {}).timeline) || {};
      const n = Object.values(tl).reduce((a, evs) => a + evs.length, 0);
      return `<tr><td>${esc(s.metadata.name)}</td><td><span class="pill">${esc(st.phase || "?")}</span></td>
        <td>${step.major ?? ""}.${step.minor ?? ""}</td><td>${n}</td></tr>`;
    }).join("")}</tbody></table>
    <h3 class="sect">submit scenario</h3>
    ${editorHtml("scenarioBody")}
    <div class="toolbar" style="margin-top:8px"><span id="scenMsg" class="msg"></span>
      <button class="primary" id="scenRun">Run</button></div>`;
  hookEditor("scenarioBody");
  setEditorValue("scenarioBody", YAML.dump({
    metadata: { name: "demo" },
    spec: { operations: [
      { step: 0, createOperation: { object: TEMPLATES.nodes } },
      { step: 0, createOperation: { object: TEMPLATES.pods } },
      { step: 0, doneOperation: {} },
    ] },
  }));
  document.getElementById("scenRefresh").addEventListener("click", () => renderScenarios(el));
  document.getElementById("scenRun").addEventListener("click", async () => {
    const msg = document.getElementById("scenMsg");
    try {
      await API.submitScenario(YAML.parse(document.getElementById("scenarioBody").value));
      msg.className = "msg ok"; msg.textContent = "submitted";
      setTimeout(() => renderScenarios(el), 500);
    } catch (e) { msg.className = "msg err"; msg.textContent = e.message; }
  });
}
