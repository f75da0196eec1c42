"""B11: one speculative round of K sessions in one launch, each wrapper
and, beside it, its plain PyTorch version.

    wrapper             kernel (csrc/)                      plain version                   JAX counterpart
    spec_eval_fused     spec_eval.cu spec_eval_cluster      eval_plain, per member          parallel/fuse.py:356
    spec_round_fused    spec_round.cu spec_round (groups)   sparse_round_plain, per member  `_run_fused`
    spec_oracle_fused   oracle.cu spec_oracle_kernel        _oracle_core, per member        (vmap at :365)

The JAX package stacks K sessions' carries and pod batches on a leading
axis and runs `jax.jit(jax.vmap(solo_fn))`.  Here each session is a
`Member`: its step (statics), its carry, its batch and the outputs it
allocated on its own thread before it joined the batch.  The dense eval
and the sparse round are the solo kernels' table launches (kernels/spec.py
`launch_eval`, `launch_round`): one StepArgs per member (kernels/step.py
`make_args`), the session picked by the CTA, so nothing is stacked or
copied, and each member's outputs equal its solo launch bit for bit.  The
oracle is the solo oracle's table launch too (kernels/spec.py
`launch_oracle`): a table of pointers, one cluster of CTAs a member.

The round functions are what the speculative stream dispatches through
the fuse coordinator (parallel/fuse.py):

  * `dense_round(m)`: the solo dense round, spec_eval (B2) then
    spec_oracle (B3), one dispatch; `dense_round.fused(args_list)` runs
    K of them as spec_eval_fused then spec_oracle_fused;
  * `sparse_round(m)`: the solo sparse round, spec_round (B4) then
    spec_oracle; `.fused` is spec_round_fused then spec_oracle_fused.

A member whose round the host will not cut brings its core-only commit
(`Member.commit`, a kernels/spec.py Commit): the oracle launch, solo or
fused, leaves its accepted prefix bound into its carry (csrc/oracle.cu),
so a fused round of K such sessions commits in its one oracle launch.

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

import torch

from ..framework.pipeline import PACK_MODES, CompactOut
from . import spec as kspec
from . import step as kstep

MAX_FUSE_SESSIONS = 16


class Member:
    """One session's part of a fused round: its step, frozen carry and
    batch, the candidate cap of a sparse round (None: dense), the round's
    rows that are not pad where the oracle launch is to commit them
    (`commit_rows`: the carry core-only and the host never cutting K;
    None: the caller commits), and, on the card, the outputs and scratch
    allocated on its own thread and stream at construction, before it
    joins a batch."""

    __slots__ = ("step", "carry", "xs", "kcand", "commit", "outs", "stream")

    def __init__(self, step, carry: dict, xs: dict, kcand: int | None = None,
                 commit_rows: int | None = None):
        self.step, self.carry, self.xs, self.kcand = step, carry, xs, kcand
        self.commit = None if commit_rows is None else kspec.Commit(carry, xs, commit_rows)
        dev = kspec._device(carry)
        self.outs = None
        self.stream = None
        if dev.type == "cuda":
            # a card mesh's xs is per card (kernels/mesh.py Cards); its
            # outputs are joined on the first card, here
            pods = (xs[0] if isinstance(xs, tuple) else xs)["is_pad"].shape[0]
            self.outs = kspec.round_outputs(step, pods, dev)
            self.stream = torch.cuda.current_stream(dev)

    @property
    def device(self) -> torch.device:
        return kspec._device(self.carry)


# ------------------------------------------------------------ solo rounds

def dense_round(m: Member):
    """The solo dense round -> (CompactOut, K): spec_eval then
    spec_oracle (speculative.py:939 `dense_round_for`).  A member whose
    workload is sharded over a mesh evaluates with B12
    `spec_eval_sharded` (kernels/mesh.py) instead of spec_eval, over a
    card mesh with B12b `spec_eval_cards`, whose outputs are joined on the
    mesh's first card, where the oracle runs."""
    mesh = m.step.cw.mesh
    if mesh is not None and mesh.cards is not None:
        from .mesh import spec_eval_cards

        outs = spec_eval_cards(m.step, m.carry, m.xs, outs=m.outs)
    elif mesh is not None:
        from .mesh import spec_eval_sharded

        outs = spec_eval_sharded(m.step, m.carry, m.xs, outs=m.outs)
    else:
        outs = kspec.spec_eval(m.step, m.carry, m.xs, outs=m.outs)
    k = kspec.spec_oracle(outs.packed_filter, outs.prefilter_reject, outs.selected,
                          out=None if m.outs is None else m.outs["k"], commit=m.commit)
    return outs, k


def sparse_round(m: Member):
    """The solo sparse round -> (packed, reject, counts, raw8, raw16,
    raw32, ovf, selected, K): spec_round then spec_oracle
    (speculative.py:381 `_sparse_round_fn`, which holds the oracle)."""
    r = kspec.spec_round(m.step, m.carry, m.xs, m.kcand, outs=m.outs)
    k = kspec.spec_oracle(r[0], r[1], r[7], out=None if m.outs is None else m.outs["k"],
                          commit=sparse_commit(m, r))
    return (*r, k)


def sparse_commit(m: Member, r: tuple):
    """A sparse member's commit with its round's feasible counts (r[2])
    and candidate cap: the oracle commits nothing where a row passes the
    cap, as the host then runs the round dense."""
    return None if m.commit is None else m.commit._replace(counts=r[2], kcand=m.kcand)


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


def spec_oracle_fused(members: list[Member], rows: list[tuple], *,
                      commits: list | None = None, _ctas: int = 0) -> list[torch.Tensor]:
    """B11 oracle: spec_oracle of every member's round in one table launch
    of the oracle kernel (kernels/spec.py launch_oracle), one cluster of
    CTAs a member, into each member's own K, with each member's commit
    (`commits`, by default each `Member.commit`) bound into its carry by
    the same launch; `spec_oracle_fused.ctas` records the CTAs a member
    took, `spec_oracle_fused.commits` the members' commits.  rows: per
    member (packed, reject, selected).  CPU tensors: oracle_commit_plain
    per member.  For tests and measurement only, `_ctas` forces the CTAs
    a member (one of kernels/spec.py ORACLE_CTAS)."""
    from . import build

    if len(rows) != len(members):
        raise ValueError(f"{len(rows)} rows for {len(members)} members")
    dev = members[0].device
    if commits is None:
        commits = [m.commit for m in members]
    if dev.type == "cpu":
        return [kspec.oracle_commit_plain(p, r, s, c) for (p, r, s), c in zip(rows, commits)]
    if build.load("oracle").kss_fuse_max() != MAX_FUSE_SESSIONS:
        raise RuntimeError("MAX_FUSE_SESSIONS differs between csrc/common.cuh and "
                           "kernels/fuse.py")
    outs = [m.outs["k"] for m in members]
    spec_oracle_fused.ctas = _launch(members, kspec.launch_oracle, "spec_oracle_fused", rows,
                                     outs, _ctas, commits)
    spec_oracle_fused.launches += 1
    spec_oracle_fused.commits += sum(c is not None for c in commits)
    return outs


spec_eval_fused.launches = 0
spec_round_fused.launches = 0
spec_eval_fused.shards = None
spec_eval_fused.light = None
spec_round_fused.pods = None
spec_eval_fused.batches = collections.Counter()
spec_round_fused.batches = collections.Counter()
spec_oracle_fused.launches = 0
spec_oracle_fused.commits = 0
spec_oracle_fused.ctas = None

KERNELS = (spec_eval_fused, spec_round_fused, spec_oracle_fused)


# ------------------------------------------------------------ fused rounds

def dense_round_fused(members: list[Member]) -> list[tuple]:
    """K dense rounds -> per member (CompactOut, K): spec_eval_fused then
    spec_oracle_fused.  Members over a card mesh (B12b) run their solo
    rounds in turn: each round's eval spans every card of the mesh
    already, each "dp" row its group of the batch (parallel/fuse.py
    _place_sessions)."""
    mesh = members[0].step.cw.mesh
    if mesh is not None and mesh.cards is not None:
        return [dense_round(m) for m in members]
    outs = spec_eval_fused(members)
    ks = spec_oracle_fused(members, [(o.packed_filter, o.prefilter_reject, o.selected)
                                     for o in outs])
    return list(zip(outs, ks))


def sparse_round_fused(members: list[Member]) -> list[tuple]:
    """K sparse rounds -> per member sparse_round's 9-tuple:
    spec_round_fused then spec_oracle_fused."""
    rounds = spec_round_fused(members)
    ks = spec_oracle_fused(members, [(r[0], r[1], r[7]) for r in rounds],
                           commits=[sparse_commit(m, r) for m, r in zip(members, rounds)])
    return [(*r, k) for r, k in zip(rounds, ks)]


def round_plain(members: list[Member]) -> list[tuple]:
    """The plain version of a fused round: each member's solo plain round
    in turn (eval_plain + oracle_commit_plain, or sparse_round_plain +
    oracle_commit_plain: with the member's commit, its carry is updated
    in place as the launch leaves it).  The tests' and chip_smoke.py's
    reference; nothing on the card's main path calls it."""
    out = []
    for m in members:
        if m.kcand is None:
            o = kspec.eval_plain(m.step, m.carry, m.xs)
            out.append((o, kspec.oracle_commit_plain(o.packed_filter, o.prefilter_reject,
                                                     o.selected, m.commit)))
        else:
            r = kspec.sparse_round_plain(m.step, m.carry, m.xs, m.kcand)
            out.append((*r, kspec.oracle_commit_plain(r[0], r[1], r[7], sparse_commit(m, r))))
    return out
