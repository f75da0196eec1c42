// API client — the web/api/v1/*.ts analogue of the reference UI
// (axios clients over the simulator API + direct resource CRUD; here the
// simulator server exposes both surfaces, server/server.py).
"use strict";

async function api(method, path, body) {
  const resp = await fetch(path, {
    method,
    headers: body !== undefined ? { "Content-Type": "application/json" } : {},
    body: body !== undefined ? JSON.stringify(body) : undefined,
  });
  const text = await resp.text();
  const data = text ? JSON.parse(text) : null;
  if (!resp.ok) throw new Error((data && data.message) || resp.statusText);
  return data;
}

const API = {
  list: (r) => api("GET", "/api/v1/" + r),
  create: (r, obj) => api("POST", "/api/v1/" + r, obj),
  update: (r, obj) => {
    const ns = obj.metadata.namespace, name = obj.metadata.name;
    return api("PUT", "/api/v1/" + r + "/" + (ns ? ns + "/" : "") + name, obj);
  },
  remove: (r, ns, name) =>
    api("DELETE", "/api/v1/" + r + "/" + (ns ? ns + "/" : "") + name),
  getSchedulerConfig: () => api("GET", "/api/v1/schedulerconfiguration"),
  applySchedulerConfig: (cfg) => api("POST", "/api/v1/schedulerconfiguration", cfg),
  exportSnapshot: () => api("GET", "/api/v1/export"),
  importSnapshot: (snap) => api("POST", "/api/v1/import", snap),
  reset: () => api("PUT", "/api/v1/reset"),
  scenarios: () => api("GET", "/api/v1/scenarios"),
  submitScenario: (s) => api("POST", "/api/v1/scenarios", s),
  metrics: () => api("GET", "/api/v1/metrics"),
  // flight-recorder surface (docs/metrics.md): the full snapshot
  // (histograms + labeled counters) and the Perfetto span-tree export;
  // pass a session id to filter either view to one session
  getMetrics: (session) =>
    api("GET", "/api/v1/metrics" + (session ? "?session=" + session : "")),
  getTrace: (limit, session) =>
    api("GET", "/api/v1/trace" +
        (limit || session ? "?" : "") +
        (limit ? "limit=" + limit : "") +
        (limit && session ? "&" : "") +
        (session ? "session=" + session : "")),
  // causal telemetry (docs/metrics.md "History & correlation"): the
  // columnar metrics history ring — pass since (absolute ring index
  // cursor from a prior response's nextIndex), stride to downsample,
  // series (comma-joined names or bare prefixes like "slo.p99"), and
  // session to filter the labeled columns — and the Perfetto export of
  // one request's causal slice by its X-KSS-Trace-Id
  getHistory: (opts) => {
    const o = opts || {};
    const q = [
      o.series ? "series=" + [].concat(o.series).join(",") : "",
      o.since != null ? "since=" + o.since : "",
      o.stride ? "stride=" + o.stride : "",
      o.session ? "session=" + o.session : "",
    ].filter(Boolean).join("&");
    return api("GET", "/api/v1/history" + (q ? "?" + q : ""));
  },
  getTraceById: (traceId, limit) =>
    api("GET", "/api/v1/trace?trace_id=" + encodeURIComponent(traceId) +
        (limit ? "&limit=" + limit : "")),
  // wave black box (docs/metrics.md post-mortem dumps): a live bundle
  // plus metadata of recently stored dumps
  getDebugDump: (session) =>
    api("GET", "/api/v1/debug/dump" + (session ? "?session=" + session : "")),
  // multi-session serving (docs/api.md): CRUD + per-session routing —
  // sessionPath("a", "pods") -> "/api/v1/sessions/a/pods"
  sessions: () => api("GET", "/api/v1/sessions"),
  createSession: (id, qos) =>
    api("POST", "/api/v1/sessions",
        Object.assign({}, id ? { id } : {}, qos ? { qos } : {})),
  deleteSession: (id) => api("DELETE", "/api/v1/sessions/" + id),
  sessionPath: (id, sub) => "/api/v1/sessions/" + id + "/" + sub,
  // SLO-driven autopilot (docs/autopilot.md): the controller block on
  // /api/v1/sessions — enabled/running, tick/decision/failsafe counts,
  // sessions currently shedding (429 + Retry-After), and the live
  // per-session control overrides
  autopilot: () => api("GET", "/api/v1/sessions").then((s) => s.autopilot),
};

// ---- watch stream (web/api/v1/watcher.ts analogue: fetch ReadableStream
// over /listwatchresources, reference watcher.ts:11-12) ------------------
function scanJson(s) { // length of first complete top-level JSON object, else 0
  let depth = 0, inStr = false, esc = false;
  for (let i = 0; i < s.length; i++) {
    const c = s[i];
    if (inStr) {
      if (esc) esc = false;
      else if (c === "\\") esc = true;
      else if (c === '"') inStr = false;
    } else if (c === '"') inStr = true;
    else if (c === "{") depth++;
    else if (c === "}") { depth--; if (depth === 0) return i + 1; }
  }
  return 0;
}

async function watchLoop(onEvent, onBatch, onStatus) {
  for (;;) {
    try {
      const resp = await fetch("/api/v1/listwatchresources");
      const reader = resp.body.getReader();
      const dec = new TextDecoder();
      onStatus(true);
      let buf = "";
      for (;;) {
        const { done, value } = await reader.read();
        if (done) break;
        buf += dec.decode(value, { stream: true });
        let i;
        while ((i = scanJson(buf)) > 0) {
          onEvent(JSON.parse(buf.slice(0, i)));
          buf = buf.slice(i);
        }
        onBatch(); // one render per network chunk, not per event
      }
    } catch (e) { /* reconnect */ }
    onStatus(false);
    await new Promise((r) => setTimeout(r, 1000));
  }
}
