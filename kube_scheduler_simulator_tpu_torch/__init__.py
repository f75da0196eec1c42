"""kube_scheduler_simulator_tpu_torch — the PyTorch and CUDA port of
kube_scheduler_simulator_tpu, for an NVIDIA Hopper card.

The JAX package stays the reference; this package keeps its module names
(state/, plugins/, framework/, store/, models/) so each counterpart is easy
to find, and imports neither JAX nor the JAX package.  Its device work is
plain PyTorch on the CPU and hand-written CUDA kernels on the card
(csrc/, bound in kernels/).

Counterpart of kube_scheduler_simulator_tpu/__init__.py:27-65: the JAX
package turns on x64 globally; here every tensor names its dtype, and the
score math is int64/float64 where the reference relies on x64.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

ANNOTATION_PREFIX = "kube-scheduler-simulator.sigs.k8s.io/"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  "cuda" (the default) needs a
    card: without one this raises instead of running on the CPU, so a
    caller that wants the plain PyTorch path passes device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
