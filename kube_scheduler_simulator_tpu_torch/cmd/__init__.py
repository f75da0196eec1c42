"""Process entry points, mirroring the reference's cmd/ binaries
(reference: simulator/cmd/simulator, cmd/scheduler, cmd/sched-recorder):

  python -m kube_scheduler_simulator_tpu_torch.cmd.simulator [--device cuda|cpu]
      the simulator server;
  python -m kube_scheduler_simulator_tpu_torch.cmd.scheduler --master URL [--device cuda|cpu]
      the standalone debuggable scheduler: the port's SchedulerEngine in a
      process of its own, against a simulator server over HTTP
      (cluster/remote.py);
  python -m kube_scheduler_simulator_tpu_torch.cmd.sched_recorder --path FILE
      the recorder: a cluster's events (cluster/kubeapi.py connect_source)
      appended to a JSON-lines record.

`--device` defaults to "cuda", which raises without a card; "cpu" runs the
plain PyTorch path.
"""
