"""Wrappers of kernel B10: the engine's host-interleaved path, one pod at
a time.

    kernel                          wrapper          plain version                JAX counterpart
    spec_eval.cu spec_eval_cluster  phased_eval      pipeline.Phased.plain_eval   framework/pipeline.py:446 build_phased (eval_fn)
    phased.cu renormalize_row       renormalize_row  pipeline.renormalize_plain   pipeline.py:198 renormalize

phased_eval launches the dense round's cluster kernel (kernels/spec.py
launch_eval) with the uncompacted outputs: one pod spread over a
thread-block cluster of up to 16 CTAs.

build_phased's bind_fn is B5's `spec_commit_bind` on a batch of one
(framework/pipeline.py `Phased.bind`).

As kernels/step.py does for the step: for tensors on the card a wrapper
launches its kernel on PyTorch's current stream, without synchronising,
and adds one to its `launches`; for tensors on the CPU it runs the plain
version.  There is no fallback: a failed build or launch raises.  Both
take the pod's xs with a leading pod axis of 1 (the engine slices
`cw.xs` with replay._slice_xs).
"""

from __future__ import annotations

import ctypes

import torch

from ..framework.pipeline import NORMALIZING, StepOut
from . import spec as kspec
from . import step as kstep


def _device(carry) -> torch.device:
    return carry["core"].requested.device


def phased_eval(step, carry: dict, xs1: dict, *, _shards: int = 0) -> StepOut:
    """B10 eval: pod 0 of xs1 against the carry, no bind -> the full
    StepOut of that pod (filter codes [F, N], raw and final [S, N] int32,
    scalar selected / feasible_count / prefilter_reject), still on the
    card; `phased_eval.shards` records the cluster size the launch took.
    CPU tensors: step.eval_plain.  For tests and measurement only,
    `_shards` forces the cluster size (kernels/spec.py EVAL_SHARDS)."""
    from ..framework.pipeline import slice_pod

    if step.out_mode != "full":
        raise ValueError("phased_eval evaluates the full step")
    dev = _device(carry)
    if dev.type == "cpu":
        return step.eval_plain(carry, slice_pod(xs1, 0))
    if xs1["is_pad"].shape[0] != 1:
        raise ValueError("phased_eval takes one pod")
    outs = kstep.alloc_outputs(step, 1, dev, slots=0)  # the kernel keeps its rows on chip
    phased_eval.shards = kspec.launch_eval("phased_eval", [(step, carry, xs1, outs)], _shards)
    phased_eval.launches += 1
    return StepOut(**{k: outs[k][0] for k in StepOut._fields})


phased_eval.launches = 0
phased_eval.shards = None


def renormalize_row(step, name: str, carry: dict, xs1: dict, raw: torch.Tensor,
                    feasible: torch.Tensor) -> torch.Tensor:
    """B10 renormalize: scorer `name`'s NormalizeScore over raw [N] int64
    against feasible [N] bool -> [N] int64 on raw's device.  A scorer
    without ScoreExtensions returns raw (the reference's `return raw`)
    and launches nothing.  CPU tensors: renormalize_plain."""
    from ..framework.pipeline import renormalize_plain, slice_pod

    dev = _device(carry)
    if dev.type == "cpu":
        return renormalize_plain(name, step.cw, carry, slice_pod(xs1, 0), raw, feasible)
    if name not in NORMALIZING:
        return raw
    n = step.cw.n_nodes
    kstep.check_device("renormalize_row", dev, step.cw.statics, carry, xs1,
                       {"raw": raw, "feasible": feasible})
    lib = kstep.load_lib("phased")
    args = kstep.make_args(step, carry, xs1, None)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    ign = torch.empty(n, dtype=torch.uint8, device=dev)
    err = lib.kss_renormalize_row(
        ctypes.byref(args), kstep.PLUGIN_IDS[name],
        kstep._ptr(raw, torch.int64, (n,), "raw"),
        kstep._ptr(feasible, torch.bool, (n,), "feasible"),
        ign.data_ptr(), out.data_ptr(), kstep.stream_of(dev))
    kstep.check_launch("renormalize_row", err)
    renormalize_row.launches += 1
    return out


renormalize_row.launches = 0
