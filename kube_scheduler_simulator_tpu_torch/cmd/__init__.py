"""Process entry points, mirroring the reference's cmd/ binaries
(reference: simulator/cmd/simulator):

  python -m kube_scheduler_simulator_tpu_torch.cmd.simulator — simulator server

The JAX package's standalone scheduler and recorder CLIs
(cmd/scheduler.py, cmd/sched_recorder.py) are not ported (ROADMAP Queue A
item 10).
"""
