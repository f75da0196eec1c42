// App shell: navigation, drawer lifecycle, header actions.  Wires the
// stores (store.js) to the views (components.js) — the pages/index.vue +
// layout analogue of the reference UI.
"use strict";

const state = {
  view: "pods",
  current: null,       // {resource, key, obj}
  tab: "manifest",
  editorNew: false,
  editorFmt: "yaml",
  formValues: null,    // structured-dialog values, kept across tab switches
  listUI: {},          // per-resource sort/filter state
};

function content() { return document.getElementById("content"); }

function renderNav() {
  const nav = document.getElementById("nav");
  nav.innerHTML = KINDS.map(([r, label]) =>
    `<a href="#" class="${state.view === r ? "sel" : ""}" data-view="${r}">
      ${label}<span class="count">${STORES[r].size}</span></a>`).join("") +
    `<a href="#" class="${state.view === "schedulerconfig" ? "sel" : ""}"
        data-view="schedulerconfig">Scheduler Config</a>` +
    `<a href="#" class="${state.view === "scenarios" ? "sel" : ""}"
        data-view="scenarios">Scenarios</a>`;
}

function setView(v) { state.view = v; renderNav(); renderList(content(), state); }

// ---- drawer -------------------------------------------------------------
function openNew(r) {
  state.current = { resource: r, key: null,
                    obj: JSON.parse(JSON.stringify(TEMPLATES[r])) };
  state.editorNew = true;
  state.formValues = null;  // fresh dialog, fresh defaults
  // structured creation dialog (reference: web/components/ per-resource
  // dialogs); kinds without field definitions fall back to the editor
  state.tab = FORM_FIELDS[r] ? "form" : "manifest";
  openDrawer("new " + r.replace(/s$/, ""));
}
function openObj(r, k) {
  state.current = { resource: r, key: k, obj: STORES[r].get(k) };
  state.editorNew = false;
  state.tab = "manifest";
  openDrawer(k);
}
function openDrawer(title) {
  document.getElementById("drawerTitle").textContent = title;
  document.getElementById("drawer").classList.add("open");
  renderDrawerTabs();
  renderDrawerBody();
}
function closeDrawer() {
  document.getElementById("drawer").classList.remove("open");
  state.current = null;
}
function renderDrawerTabs() {
  const tabs = [["manifest", "Manifest"]];
  if (state.current && state.editorNew && FORM_FIELDS[state.current.resource])
    tabs.unshift(["form", "Form"]);
  if (state.current && state.current.resource === "pods" && !state.editorNew)
    tabs.push(["results", "Scheduling results"]);
  document.getElementById("drawerTabs").innerHTML = tabs.map(([t, label]) =>
    `<a href="#" class="${state.tab === t ? "sel" : ""}" data-tab="${t}">${label}</a>`).join("");
  document.getElementById("deleteBtn").style.display = state.editorNew ? "none" : "";
}
function renderDrawerBody() {
  const el = document.getElementById("drawerBody");
  const cur = state.current;
  if (!cur) return;
  if (state.tab === "form") {
    el.innerHTML = formHtml(cur.resource, state.formValues)
      + `<div id="editMsg" class="msg"></div>`;
    document.getElementById("applyBtn").style.display = "";
    return;
  }
  if (state.tab === "manifest") {
    el.innerHTML = `<div class="toolbar"><span class="kv">format</span>
        <select id="manFmt"><option ${state.editorFmt === "yaml" ? "selected" : ""}>yaml</option>
          <option ${state.editorFmt === "json" ? "selected" : ""}>json</option></select>
        <span style="margin-left:auto"></span></div>
      ${editorHtml("editor")}<div id="editMsg" class="msg"></div>`;
    hookEditor("editor");
    setEditorValue("editor", state.editorFmt === "yaml"
      ? YAML.dump(cur.obj) : JSON.stringify(cur.obj, null, 2));
    document.getElementById("applyBtn").style.display = "";
    document.getElementById("manFmt").addEventListener("change", (ev) => {
      const msg = document.getElementById("editMsg");
      try {
        const text = document.getElementById("editor").value;
        const obj = state.editorFmt === "yaml" ? YAML.parse(text) : JSON.parse(text);
        state.editorFmt = ev.target.value;
        setEditorValue("editor", state.editorFmt === "yaml"
          ? YAML.dump(obj) : JSON.stringify(obj, null, 2));
        msg.textContent = "";
      } catch (e) { msg.className = "msg err"; msg.textContent = e.message; }
    });
  } else {
    document.getElementById("applyBtn").style.display = "none";
    el.innerHTML = renderResults(cur.obj);
  }
}
async function applyEdit() {
  const msg = document.getElementById("editMsg");
  try {
    const r = state.current.resource;
    const obj = state.tab === "form"
      ? buildManifest(r, collectForm(r))
      : (state.editorFmt === "yaml"
          ? YAML.parse(document.getElementById("editor").value)
          : JSON.parse(document.getElementById("editor").value));
    if (state.editorNew) await API.create(r, obj);
    else await API.update(r, obj);
    msg.className = "msg ok";
    msg.textContent = "applied";
    state.editorNew = false;
    state.current.obj = obj;
  } catch (e) { msg.className = "msg err"; msg.textContent = e.message; }
}
async function deleteCurrent() {
  const { resource, obj } = state.current;
  await API.remove(resource, obj.metadata.namespace, obj.metadata.name);
  closeDrawer();
}

// ---- header actions -----------------------------------------------------
async function doExport() {
  const snap = await API.exportSnapshot();
  const blob = new Blob([JSON.stringify(snap, null, 2)], { type: "application/json" });
  const a = document.createElement("a");
  a.href = URL.createObjectURL(blob);
  a.download = "snapshot.json";
  a.click();
  URL.revokeObjectURL(a.href);
}
async function doImport(file) {
  if (!file) return;
  await API.importSnapshot(JSON.parse(await file.text()));
  document.getElementById("fileInput").value = "";
}
async function doReset() {
  if (confirm("Reset the cluster to its boot state?")) await API.reset();
}

// ---- wiring -------------------------------------------------------------
function boot() {
  for (const [r] of KINDS) {
    STORES[r].subscribe(() => {
      renderNav();
      if (state.view === r) renderList(content(), state);
      const cur = state.current;
      if (cur && cur.resource === r && cur.key && !state.editorNew) {
        const fresh = STORES[r].get(cur.key);
        if (fresh) {
          cur.obj = fresh;
          if (state.tab === "results") renderDrawerBody();
        }
      }
    });
  }
  document.getElementById("nav").addEventListener("click", (e) => {
    const a = e.target.closest("a[data-view]");
    if (a) { setView(a.dataset.view); e.preventDefault(); }
  });
  content().addEventListener("click", (e) => {
    const nb = e.target.closest("button[data-new]");
    if (nb) return openNew(nb.dataset.new);
    const tr = e.target.closest("tr.row[data-key]");
    if (tr) openObj(tr.dataset.res, tr.dataset.key);
  });
  document.getElementById("drawerTabs").addEventListener("click", (e) => {
    const a = e.target.closest("a[data-tab]");
    if (a) {
      if (state.tab === "form" && a.dataset.tab === "manifest") {
        // leaving the form: keep the entered values for the round-trip
        // and seed the editor with the built manifest
        state.formValues = collectForm(state.current.resource);
        state.current.obj = buildManifest(
          state.current.resource, state.formValues);
      }
      state.tab = a.dataset.tab;
      renderDrawerTabs();
      renderDrawerBody();
      e.preventDefault();
    }
  });
  document.getElementById("applyBtn").addEventListener("click", applyEdit);
  document.getElementById("deleteBtn").addEventListener("click", deleteCurrent);
  document.getElementById("closeBtn").addEventListener("click", closeDrawer);
  document.getElementById("exportBtn").addEventListener("click", doExport);
  document.getElementById("importBtn").addEventListener("click",
    () => document.getElementById("fileInput").click());
  document.getElementById("fileInput").addEventListener("change",
    (e) => doImport(e.target.files[0]));
  document.getElementById("resetBtn").addEventListener("click", doReset);

  renderNav();
  renderList(content(), state);
  watchLoop(
    handleWatchEvent,
    () => { flushStores(); },
    (live) => {
      document.getElementById("livedot").classList.toggle("live", live);
      if (live) resetStores();
    },
  );
}
document.addEventListener("DOMContentLoaded", boot);
