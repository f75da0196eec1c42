"""`python -m kube_scheduler_simulator_tpu_torch.server`: the simulator
server (cmd/simulator.py)."""

from .server import main

if __name__ == "__main__":
    main()
