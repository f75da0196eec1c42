"""Standalone recorder CLI (reference: simulator/cmd/sched-recorder/recorder.go:31-93).

Watches the 7 resource kinds on a cluster and appends JSON-lines records
to --path.  Flags mirror the reference: --path is required; --kubeconfig
points at the cluster — an actual kubeconfig FILE for a real
kube-apiserver (the reference's clientcmd path, recorder.go:69-93), a
bare real-apiserver URL (KWOK without auth), or a simulator server URL
(cluster/kubeapi.connect_source decides); --duration limits the
recording (0 = until SIGINT, the reference's behavior without
--duration).

A copy of kube_scheduler_simulator_tpu/cmd/sched_recorder.py for the port:

    python -m kube_scheduler_simulator_tpu_torch.cmd.sched_recorder --path FILE \
        [--kubeconfig FILE|URL] [--duration S]

It schedules nothing, so it takes no device.
"""

from __future__ import annotations

import argparse
import signal
import threading


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="sched-recorder")
    ap.add_argument("--path", required=True, help="record file to write (JSON lines)")
    ap.add_argument("--kubeconfig", default="http://localhost:1212",
                    help="cluster to record: kubeconfig file path, real "
                         "apiserver URL, or simulator server URL")
    ap.add_argument("--duration", type=float, default=0,
                    help="seconds to record; 0 records until SIGINT")
    args = ap.parse_args(argv)

    from ..cluster.kubeapi import connect_source
    from ..services.recorder import RecorderService

    source = connect_source(args.kubeconfig)
    recorder = RecorderService(source, args.path)
    recorder.run()
    print(f"recording {args.kubeconfig} -> {args.path}")

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait(args.duration if args.duration > 0 else None)
    recorder.stop()
    if hasattr(source, "close"):
        source.close()
    elif hasattr(source, "stop"):
        source.stop()
    print("recording stopped")


if __name__ == "__main__":
    main()
