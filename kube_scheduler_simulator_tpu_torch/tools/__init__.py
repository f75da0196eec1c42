"""The port's operations tooling: end-to-end gates that drive the port's
own seams, each a module with a `main(argv)` and `--device` (default
"cuda"; "cpu" runs the plain PyTorch path):

  * `blackbox_smoke` — a wave aborted under a one-rule fault plan ships a
    well-formed post-mortem dump (utils/blackbox.py validate_dump);
  * `obs_smoke` — one trace id threads the spans, the dump with its
    telemetry-history window and the Perfetto export;
  * `chaos` — concurrent two-session waves under seeded fault plans over
    every seam, held byte-equal to their fault-free runs;
  * `soak` — a live SimulatorServer with the autopilot on: the SLO held
    under churn, load shed with Retry-After and lifted, the degradation
    ladder walked down and back;
  * `lockwitness` — the runtime lock-order witness the chaos gate arms
    under KSS_TPU_LOCK_WITNESS=1.

Run one with `python -m kube_scheduler_simulator_tpu_torch.tools.<name>
[--device cpu]`.  Each can also be called in-process (`main([...])`, or
the module's own entry such as `chaos.run_seed`): the knobs a tool sets
are restored when it returns (`scoped_env`), so a caller's environment
and armed fault plan survive it."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def scoped_env(**values):
    """The environment variables set (None: unset) for the block, each
    restored after it."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help='where the waves run: "cuda" (the default, the card\'s '
                             'kernels) or "cpu" (the plain PyTorch path)')
