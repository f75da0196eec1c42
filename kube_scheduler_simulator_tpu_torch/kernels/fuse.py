"""B11: one speculative round of K sessions in one launch, each wrapper
and, beside it, its plain PyTorch version.

    wrapper             kernel (csrc/)                      plain version                   JAX counterpart
    spec_eval_fused     spec_eval.cu spec_eval_cluster      eval_plain, per member          parallel/fuse.py:356
    spec_round_fused    spec_round.cu spec_round (groups)   sparse_round_plain, per member  `_run_fused`
    spec_oracle_fused   fuse.cu spec_oracle_fused           _oracle_core, per member        (vmap at :365)

The JAX package stacks K sessions' carries and pod batches on a leading
axis and runs `jax.jit(jax.vmap(solo_fn))`.  Here each session is a
`Member`: its step (statics), its carry, its batch and the outputs it
allocated on its own thread before it joined the batch.  The dense eval
and the sparse round are the solo kernels' table launches (kernels/spec.py
`launch_eval`, `launch_round`): one StepArgs per member (kernels/step.py
`make_args`), the session picked by the CTA, so nothing is stacked or
copied, and each member's outputs equal its solo launch bit for bit.  The
oracle's kernel takes a table of pointers, one block a member.

The round functions are what the speculative stream dispatches through
the fuse coordinator (parallel/fuse.py):

  * `dense_round(m)`: the solo dense round, spec_eval (B2) then
    spec_oracle (B3), one dispatch; `dense_round.fused(args_list)` runs
    K of them as spec_eval_fused then spec_oracle_fused;
  * `sparse_round(m)`: the solo sparse round, spec_round (B4) then
    spec_oracle; `.fused` is spec_round_fused then spec_oracle_fused.

As in kernels/spec.py: for tensors on the card a wrapper launches on
PyTorch's current stream without synchronising and adds one to its
`launches`; for tensors on the CPU it runs the plain version, each
member's solo plain round in turn.  There is no fallback: a failed build
or launch raises.

Streams.  The leader launches on its own current stream.  A member whose
current stream is another one (sessions given streams of their own) is
joined by an event recorded on its stream, which the leader's stream
waits on before the launch; after it, the member's stream waits on an
event recorded on the leader's.  The member thread is blocked between
its join and the batch's end, so events recorded then see all of its
work.  Today every session thread launches on the one default stream,
and no event is recorded.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..framework.pipeline import PACK_MODES, CompactOut
from . import spec as kspec
from . import step as kstep

MAX_FUSE_SESSIONS = 16


class Member:
    """One session's part of a fused round: its step, frozen carry and
    batch, the candidate cap of a sparse round (None: dense), and, on
    the card, the outputs and scratch allocated on its own thread and
    stream at construction, before it joins a batch."""

    __slots__ = ("step", "carry", "xs", "kcand", "outs", "stream")

    def __init__(self, step, carry: dict, xs: dict, kcand: int | None = None):
        self.step, self.carry, self.xs, self.kcand = step, carry, xs, kcand
        dev = kspec._device(carry)
        self.outs = None
        self.stream = None
        if dev.type == "cuda":
            self.outs = kspec.round_outputs(step, xs["is_pad"].shape[0], dev)
            self.stream = torch.cuda.current_stream(dev)

    @property
    def device(self) -> torch.device:
        return kspec._device(self.carry)


# ------------------------------------------------------------ solo rounds

def dense_round(m: Member):
    """The solo dense round -> (CompactOut, K): spec_eval then
    spec_oracle (speculative.py:939 `dense_round_for`).  A member whose
    workload is sharded over a mesh evaluates with B12
    `spec_eval_sharded` (kernels/mesh.py) instead of spec_eval."""
    if m.step.cw.mesh is not None:
        from .mesh import spec_eval_sharded

        outs = spec_eval_sharded(m.step, m.carry, m.xs, outs=m.outs)
    else:
        outs = kspec.spec_eval(m.step, m.carry, m.xs, outs=m.outs)
    k = kspec.spec_oracle(outs.packed_filter, outs.prefilter_reject, outs.selected,
                          out=None if m.outs is None else m.outs["k"])
    return outs, k


def sparse_round(m: Member):
    """The solo sparse round -> (packed, reject, counts, raw8, raw16,
    raw32, ovf, selected, K): spec_round then spec_oracle
    (speculative.py:381 `_sparse_round_fn`, which holds the oracle)."""
    r = kspec.spec_round(m.step, m.carry, m.xs, m.kcand, outs=m.outs)
    k = kspec.spec_oracle(r[0], r[1], r[7], out=None if m.outs is None else m.outs["k"])
    return (*r, k)


def _members(args_list: list) -> list[Member]:
    return [args[0] for args in args_list]


dense_round.fused = lambda args_list: dense_round_fused(_members(args_list))
sparse_round.fused = lambda args_list: sparse_round_fused(_members(args_list))


# ------------------------------------------------------------ checks

def mesh_shards(step) -> int:
    """The "nodes" shards of a member's mesh, 1 without one (a fuse family
    holds one mesh: parallel/fuse.py)."""
    return step.cw.mesh.shape["nodes"] if step.cw.mesh is not None else 1


def state_shape(step) -> tuple:
    """What a member's CTA state takes in the eval kernel (csrc/cluster.cuh
    step_smem): its scorers and, where it has them, NodeVolumeLimits'
    volumes and drivers and VolumeBinding's PVs."""
    st = step.cw.statics
    nvl = st["NodeVolumeLimits"].driver_onehot.shape if "NodeVolumeLimits" in st else None
    vb = st["VolumeBinding"].pv_cap.shape[0] if "VolumeBinding" in st else None
    return len(step.score_names), nvl, vb


def _check_members(members: list[Member], sparse: bool) -> torch.device:
    """Every member on one device, with the same batch, node count, output
    widths, pack width, candidate cap and state bytes (state_shape): what
    one launch can take.  The fuse family (parallel/speculative.py
    `_fuse_family`) makes a difference impossible; a caller that breaks
    it gets an error, not a wrong answer."""
    if not 1 <= len(members) <= MAX_FUSE_SESSIONS:
        raise ValueError(f"{len(members)} members: a fused round takes 1 to {MAX_FUSE_SESSIONS}")
    first = members[0]

    def shape(m: Member):
        groups = kstep._score_groups(m.step)
        return (m.device, m.step.out_mode, m.xs["is_pad"].shape[0], m.step.cw.n_nodes,
                PACK_MODES[m.step.pack_mode][0], groups[2], groups[4], m.kcand,
                state_shape(m.step), mesh_shards(m.step))

    want = shape(first)
    for i, m in enumerate(members):
        if m.step.out_mode != "compact":
            raise ValueError("a fused round evaluates the compact step")
        got = shape(m)
        if got != want:
            raise ValueError(f"member {i} does not fit the batch: (device, mode, batch, nodes, "
                             f"pack dtype, raw widths, raw32 bytes, kcand, (scorers, volume "
                             f"limits' volumes x drivers, PVs), mesh shards) {got} != {want}")
        if (m.kcand is not None) != sparse:
            raise ValueError(f"member {i}: a {'sparse' if sparse else 'dense'} round needs "
                             f"{'a' if sparse else 'no'} candidate cap")
    return first.device


def _join_streams(members: list[Member]) -> None:
    lead = members[0].stream
    for m in members[1:]:
        if m.stream != lead:
            ev = torch.cuda.Event()
            ev.record(m.stream)
            lead.wait_event(ev)


def _release_streams(members: list[Member]) -> None:
    lead = members[0].stream
    done = None
    for m in members[1:]:
        if m.stream != lead:
            if done is None:
                done = torch.cuda.Event()
                done.record(lead)
            m.stream.wait_event(done)


def _launch(members: list[Member], fn, *args):
    """fn(*args) with the members' streams joined to the leader's and
    released after: it launches on the leader's stream."""
    _join_streams(members)
    with torch.cuda.stream(members[0].stream):
        out = fn(*args)
    _release_streams(members)
    return out


def _entries(members: list[Member]) -> list:
    return [(m.step, m.carry, m.xs, m.outs) for m in members]


# ------------------------------------------------------------ B11 kernels

def spec_eval_fused(members: list[Member], *, _shards: int = 0,
                    _light: bool | None = None) -> list[CompactOut]:
    """B11 dense eval: spec_eval of every member in one launch of its
    kernel over the members' table, one cluster a pod of S CTAs, S from
    the K x B pods (kernels/spec.py launch_eval); members sharded over a
    mesh (B12) take spec_eval_sharded's plan, each shard a group of S
    CTAs.  `spec_eval_fused.shards` records S, `spec_eval_fused.light`
    the CTA shape, `spec_eval_fused.batches` the launches by (K, b).  CPU
    tensors: eval_plain per member (the sharded twin on a mesh).  For
    tests and measurement only, `_shards` forces S (kernels/spec.py
    EVAL_SHARDS) and `_light` the CTA shape."""
    dev = _check_members(members, sparse=False)
    mesh = mesh_shards(members[0].step)
    if dev.type == "cpu":
        if mesh > 1:
            from .mesh import spec_eval_sharded_plain

            return [spec_eval_sharded_plain(m.step, m.carry, m.xs) for m in members]
        return [kspec.eval_plain(m.step, m.carry, m.xs) for m in members]
    spec_eval_fused.shards, spec_eval_fused.light = _launch(
        members, kspec.launch_eval, "spec_eval_fused", _entries(members), _shards, mesh, _light)
    spec_eval_fused.launches += 1
    spec_eval_fused.batches[(len(members), members[0].xs["is_pad"].shape[0])] += 1
    return [CompactOut(**{k: m.outs[k] for k in CompactOut._fields}) for m in members]


def spec_round_fused(members: list[Member], *, _pods: int = 0,
                     _clock: list | None = None) -> list[tuple]:
    """B11 sparse round: spec_round of every member in one launch of its
    pod-group kernel over the members' table (kernels/spec.py
    launch_round); `spec_round_fused.pods` records the group size,
    `spec_round_fused.batches` the launches by (K, b).  -> per member
    (packed, reject, counts, raw8, raw16, raw32, ovf, selected).  CPU
    tensors: sparse_round_plain per member.  For tests and measurement
    only, `_pods` forces the group size (kernels/spec.py ROUND_PODS);
    `_clock` (one zeroed int64 [B * CLOCK_SLOTS] tensor per member) runs
    the phase-clock build (kernels/spec.py ROUND_CLOCK_PHASES)."""
    dev = _check_members(members, sparse=True)
    if dev.type == "cpu":
        return [kspec.sparse_round_plain(m.step, m.carry, m.xs, m.kcand) for m in members]
    spec_round_fused.pods = _launch(members, kspec.launch_round, "spec_round_fused",
                                    _entries(members), members[0].kcand, _pods, _clock)
    spec_round_fused.launches += 1
    spec_round_fused.batches[(len(members), members[0].xs["is_pad"].shape[0])] += 1
    return [kspec.round_tuple(m.outs) for m in members]


def spec_oracle_fused(members: list[Member], rows: list[tuple]) -> list[torch.Tensor]:
    """B11 oracle: spec_oracle of every member's round in one launch, grid
    K, into each member's own K.  rows: per member (packed, reject,
    selected).  CPU tensors: _oracle_core per member."""
    from . import build

    if len(rows) != len(members):
        raise ValueError(f"{len(rows)} rows for {len(members)} members")
    dev = members[0].device
    if dev.type == "cpu":
        return [kspec._oracle_core(p, r, s, p.shape[0]) for p, r, s in rows]
    b, n = rows[0][0].shape
    dtype = rows[0][0].dtype
    k = len(members)
    packed, reject, selected, out_k = ((ctypes.c_void_p * k)() for _ in range(4))
    for i, ((p, r, s), m) in enumerate(zip(rows, members)):
        kstep.check_device("spec_oracle_fused", dev, {"p": p, "r": r, "s": s})
        packed[i] = kstep._ptr(p, dtype, (b, n), "packed")
        reject[i] = kstep._ptr(r, torch.int32, (b,), "prefilter_reject")
        selected[i] = kstep._ptr(s, torch.int32, (b,), "selected")
        out_k[i] = kstep._ptr(m.outs["k"], torch.int32, (), "k")
    lib = build.load("fuse")
    if lib.kss_fuse_max() != MAX_FUSE_SESSIONS:
        raise RuntimeError("MAX_FUSE_SESSIONS differs between csrc/common.cuh and "
                           "kernels/fuse.py")
    _launch(members, lambda: kstep.check_launch("spec_oracle_fused", lib.kss_spec_oracle_fused(
        packed, reject, selected, out_k, k, rows[0][0].element_size(), b, n,
        kstep.stream_of(dev))))
    spec_oracle_fused.launches += 1
    return [m.outs["k"] for m in members]


spec_eval_fused.launches = 0
spec_round_fused.launches = 0
spec_eval_fused.shards = None
spec_eval_fused.light = None
spec_round_fused.pods = None
spec_eval_fused.batches = collections.Counter()
spec_round_fused.batches = collections.Counter()
spec_oracle_fused.launches = 0

KERNELS = (spec_eval_fused, spec_round_fused, spec_oracle_fused)


# ------------------------------------------------------------ fused rounds

def dense_round_fused(members: list[Member]) -> list[tuple]:
    """K dense rounds -> per member (CompactOut, K): spec_eval_fused then
    spec_oracle_fused."""
    outs = spec_eval_fused(members)
    ks = spec_oracle_fused(members, [(o.packed_filter, o.prefilter_reject, o.selected)
                                     for o in outs])
    return list(zip(outs, ks))


def sparse_round_fused(members: list[Member]) -> list[tuple]:
    """K sparse rounds -> per member sparse_round's 9-tuple:
    spec_round_fused then spec_oracle_fused."""
    rounds = spec_round_fused(members)
    ks = spec_oracle_fused(members, [(r[0], r[1], r[7]) for r in rounds])
    return [(*r, k) for r, k in zip(rounds, ks)]


def round_plain(members: list[Member]) -> list[tuple]:
    """The plain version of a fused round: each member's solo plain round
    in turn (eval_plain + _oracle_core, or sparse_round_plain +
    _oracle_core).  The tests' and chip_smoke.py's reference; nothing on
    the card's main path calls it."""
    out = []
    for m in members:
        if m.kcand is None:
            o = kspec.eval_plain(m.step, m.carry, m.xs)
            out.append((o, kspec._oracle_core(o.packed_filter, o.prefilter_reject,
                                              o.selected, o.selected.shape[0])))
        else:
            r = kspec.sparse_round_plain(m.step, m.carry, m.xs, m.kcand)
            out.append((*r, kspec._oracle_core(r[0], r[1], r[7], r[7].shape[0])))
    return out
