"""Web UI: a dependency-free single-page app served by the simulator.

Capability parity with the reference's Nuxt 2 frontend (reference: web/),
laid out the same way the reference splits concerns:

  api.js        — API clients + the watch-stream consumer
                  (reference: web/api/v1/*.ts, watcher.ts:11-12)
  store.js      — per-resource reactive stores fed by the watch stream
                  (reference: web/store/*.ts)
  components.js — per-kind resource tables (sort/filter/namespace), the
                  line-numbered highlighted YAML/JSON manifest editor
                  (the vue-monaco analogue), scheduling-result tables
                  from the Pod annotations
                  (reference: web/components/, lib/util.ts:30-44)
  forms.js      — structured creation dialogs (per-kind field forms ->
                  manifest) + the scheduler-config plugin table
                  (reference: web/components/ per-resource dialogs)
  app.js        — navigation/drawer shell (reference: pages/index.vue)
  yaml.js       — YAML codec for the k8s-manifest subset

Documented divergence: served by the simulator server itself at `/`
instead of a separate Node process on :3000 (compose.yml:43-52).

A copy of kube_scheduler_simulator_tpu/web/__init__.py.
"""

from pathlib import Path

STATIC_DIR = Path(__file__).parent

_CTYPES = {".js": "text/javascript; charset=utf-8",
           ".css": "text/css; charset=utf-8"}


def index_html() -> bytes:
    return (STATIC_DIR / "index.html").read_bytes()


def static_file(name: str) -> tuple[bytes | None, str]:
    """(content, content-type) for a flat UI asset, or (None, "") when the
    name is unknown or tries to traverse."""
    suffix = Path(name).suffix
    if "/" in name or "\\" in name or name.startswith(".") or suffix not in _CTYPES:
        return None, ""
    path = STATIC_DIR / name
    if not path.is_file():
        return None, ""
    return path.read_bytes(), _CTYPES[suffix]
