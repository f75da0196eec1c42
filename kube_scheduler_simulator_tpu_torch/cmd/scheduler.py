"""Standalone debuggable-scheduler main (reference:
simulator/cmd/scheduler/scheduler.go:16-25 +
simulator/pkg/debuggablescheduler/debuggable_scheduler.go:46-88 flags).

Runs the tensor scheduling engine in its OWN process against a simulator
server reached over HTTP — the analogue of the reference's
simulator-scheduler container talking to the KWOK apiserver through
client-go.  Flags mirror the reference: `--config` is the
KubeSchedulerConfiguration the scheduler boots with (re-read only at
boot, exactly like the reference's container that must be restarted to
pick up config changes), `--master` the cluster URL, `--proxy-port` the
extender-proxy port (reference default 1212,
debuggable_scheduler.go:48-53).

The extender proxy is only bound when the config declares extenders; it
serves POST /api/v1/extender/<verb>/<i> by recording + forwarding to the
real extender, like the reference's in-process echo server
(pkg/debuggablescheduler/server.go:26-60).

Run the simulator server with externalSchedulerEnabled: true (or env
EXTERNAL_SCHEDULER_ENABLED=1) so its in-process loop doesn't compete.

A copy of kube_scheduler_simulator_tpu/cmd/scheduler.py for the port:

    python -m kube_scheduler_simulator_tpu_torch.cmd.scheduler --master URL \
        [--config FILE] [--proxy-port N] [--once] [--device cuda|cpu]

`--config` is YAML, or JSON (read without PyYAML).  `--device` is where
the engine schedules: "cuda" by default, which needs a card and raises
without one (there is no CPU fallback); "cpu" runs the plain PyTorch
path.  The JAX main's platform guard (apply_env_platform) is a JAX step
the port does not take.
"""

from __future__ import annotations

import argparse
import json
import re
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _extender_proxy(scheduler_service, port: int) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_POST(self):
            m = re.fullmatch(
                r"/api/v1/extender/(filter|prioritize|preempt|bind)/(\d+)",
                self.path.rstrip("/"),
            )
            svc = scheduler_service.extender_service
            if not m or svc is None:
                return self._json(404, {"message": "unknown extender route"})
            length = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(length) or b"{}") if length else {}
            except ValueError as e:
                return self._json(400, {"message": f"bad request body: {e}"})
            try:
                out = svc.handle(m.group(1), int(m.group(2)), body)
            except IndexError as e:
                return self._json(400, {"message": str(e)})
            except Exception as e:  # unreachable extender backend, etc.
                return self._json(500, {"message": str(e)})
            self._json(200, out)

        def _json(self, code, obj):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="scheduler")
    ap.add_argument("--config", default="",
                    help="KubeSchedulerConfiguration YAML path (boot-time only)")
    ap.add_argument("--master", default="http://localhost:1212",
                    help="simulator server URL (the fake apiserver)")
    ap.add_argument("--proxy-port", type=int, default=1213,
                    help="extender proxy port (bound only when extenders are "
                         "configured; the reference defaults to 1212, "
                         "debuggable_scheduler.go:48-53, but its scheduler runs "
                         "in its own container — on one host that would "
                         "collide with the simulator server's :1212)")
    ap.add_argument("--once", action="store_true",
                    help="schedule currently-pending pods, then exit")
    ap.add_argument("--device", default="cuda",
                    help="where the engine schedules: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..cluster.remote import RemoteCluster
    from ..framework.engine import SchedulerEngine
    from ..scheduler.service import SchedulerService
    from ..server.di import SchedulingLoop

    device = resolve_device(args.device)  # no card: raise before dialing
    cfg = None
    if args.config:
        with open(args.config) as f:
            text = f.read()
        try:
            cfg = json.loads(text)  # JSON, a subset of YAML, needs no PyYAML
        except ValueError:
            import yaml

            cfg = yaml.safe_load(text)

    remote = RemoteCluster(args.master)
    engine = SchedulerEngine(remote, device=device)
    service = SchedulerService(engine, cfg)

    proxy = None
    if service.extender_service is not None:
        proxy = _extender_proxy(service, args.proxy_port)
        print(f"extender proxy listening on :{args.proxy_port}")

    if args.once:
        n = engine.schedule_pending()
        print(f"scheduled {n} pod(s)")
    else:
        loop = SchedulingLoop(remote, engine)
        loop.start()
        loop.kick()  # pods may already be pending
        print(f"debuggable scheduler ({device.type}) running against {args.master}")
        stop = threading.Event()
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        stop.wait()
        loop.stop()
    if proxy is not None:
        proxy.shutdown()
    remote.close()


if __name__ == "__main__":
    main()
