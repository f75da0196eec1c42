"""Wrappers of kernel B10: the engine's host-interleaved path, one pod at
a time.

    kernel                          wrapper          plain version                JAX counterpart
    spec_eval.cu spec_eval_cluster  phased_eval      pipeline.Phased.plain_eval   framework/pipeline.py:446 build_phased (eval_fn)
    phased.cu renormalize_rows      renormalize_rows pipeline.renormalize_plain   pipeline.py:198 renormalize
                                                     (per row)

phased_eval launches the dense round's cluster kernel (kernels/spec.py
launch_eval) with the uncompacted outputs: one pod spread over a
thread-block cluster of up to 16 CTAs.  renormalize_rows takes R scorers'
rows of one pod in one launch, one cluster of G CTAs a row
(`renorm_ctas`): the engine defers a pod's rows and flushes them at once
(framework/engine.py `_hooked_score_phase`).

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

import collections
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
    outs = kstep.alloc_outputs(step, 1, dev)
    phased_eval.shards, _ = kspec.launch_eval("phased_eval", [(step, carry, xs1, outs)],
                                              _shards)
    phased_eval.launches += 1
    return StepOut(**{k: outs[k][0] for k in StepOut._fields})


phased_eval.launches = 0
phased_eval.shards = None


RENORM_CTAS = (1, 2, 4, 8, 16)  # CTAs of a row's cluster in csrc/phased.cu
RENORM_THREADS = 512            # the widest CTA (csrc/phased.cu RENORM_THREADS)
RENORM_PASSES = 3               # passes of a CTA over its slice before G grows
# rows a launch (csrc/phased.cu RENORM_MAX_ROWS): a pod's rows are its
# scorers with ScoreExtensions, each once, so at most four reach it
MAX_ROWS = 16


def renorm_ctas(n: int) -> int:
    """G of a renormalize_rows launch over rows of n nodes: the smallest
    of RENORM_CTAS at which a CTA of RENORM_THREADS threads covers its
    slice (kernels/spec.py cluster_slices) in at most RENORM_PASSES
    passes, else 16.  The launch and the cluster's barriers cost more
    than a pass (the card's readings at 5,000 nodes, PERF.md §6),
    so 5,000 nodes take 4 (1,250 a slice)."""
    for g in RENORM_CTAS:
        if -(-n // g) <= RENORM_THREADS * RENORM_PASSES:
            return g
    return RENORM_CTAS[-1]


def renormalize_rows(step, names: list[str], carry: dict, xs1: dict, raws: torch.Tensor,
                     feasible: torch.Tensor, *, _ctas: int = 0) -> torch.Tensor:
    """B10 renormalize for R scorers of one pod, each with ScoreExtensions
    (NORMALIZING; pipeline.renormalize returns the others' raws): row i is
    scorer names[i]'s NormalizeScore over raws[i] ([R, N] int64) against
    feasible [N] bool -> [R, N] int64 on raws' device.  CUDA tensors: one
    launch, one thread-block cluster of renorm_ctas(N) CTAs a row;
    `renormalize_rows.ctas` records G, `renormalize_rows.rows` the
    launches by R.  CPU tensors: renormalize_plain per row, stacked.  For
    tests and measurement only, `_ctas` forces G (one of RENORM_CTAS)."""
    from ..framework.pipeline import renormalize_plain, slice_pod

    dev = _device(carry)
    r, n = len(names), step.cw.n_nodes
    if tuple(raws.shape) != (r, n) or not 1 <= r <= MAX_ROWS:
        raise ValueError(f"renormalize_rows: raws {tuple(raws.shape)} for {r} scorers "
                         f"of {n} nodes (1 to {MAX_ROWS} rows)")
    if not set(names) <= set(NORMALIZING):
        raise ValueError(f"renormalize_rows: {sorted(set(names) - set(NORMALIZING))} have "
                         f"no NormalizeScore here")
    if dev.type == "cpu":
        sl = slice_pod(xs1, 0)
        return torch.stack([renormalize_plain(nm, step.cw, carry, sl, raws[i], feasible)
                            for i, nm in enumerate(names)])
    if _ctas not in (0, *RENORM_CTAS):
        raise ValueError(f"renormalize_rows: {_ctas} CTAs a row, not one of {RENORM_CTAS}")
    kstep.check_device("renormalize_rows", dev, step.cw.statics, carry, xs1,
                       {"raws": raws, "feasible": feasible})
    lib = kstep.load_lib("phased")
    args = kstep.make_args(step, carry, xs1, None)
    pids = (ctypes.c_int * r)(*[kstep.PLUGIN_IDS[nm] for nm in names])
    g = _ctas or renorm_ctas(n)
    out = torch.empty((r, n), dtype=torch.int64, device=dev)
    err = lib.kss_renormalize_rows(
        ctypes.byref(args), pids, r, kstep._ptr(raws, torch.int64, (r, n), "raws"),
        kstep._ptr(feasible, torch.bool, (n,), "feasible"), out.data_ptr(), g,
        kstep.stream_of(dev))
    kstep.check_launch("renormalize_rows", err)
    renormalize_rows.launches += 1
    renormalize_rows.ctas = g
    renormalize_rows.rows[r] += 1
    return out


renormalize_rows.launches = 0
renormalize_rows.ctas = None
renormalize_rows.rows = collections.Counter()
