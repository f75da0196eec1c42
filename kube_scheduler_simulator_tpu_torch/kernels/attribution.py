"""B7, the per-chunk attribution of a device-resident replay chunk: the
wrapper of csrc/attribution.cu and, beside it, its plain PyTorch version.

    kernel (csrc/)                   wrapper            plain version
    B7 attribution.cu att_kernel<T>  chunk_attribution  chunk_attribution_plain

The JAX counterpart is framework/replay.py:1217 `_build_att_fn.fn`.  Both
versions return one dict of int64 tensors (uint8 for the bitmap), each
key present only when the chunk has what it counts:

  f_rejects   [F]      nodes whose first failing filter is f
  f_evaluated [F]      (pod, node) pairs filter f ran on: all-pass nodes
                       plus nodes failing at a later filter, 0 for a pod
                       that PreFilter-skipped f
  s_sums      [C, Q]   per pod, device score column q's raw sum over its
                       feasible nodes, 0 where the pod did not score
  s_evaluated [Q]      feasible nodes column q scored
  feas_packed [C, NB]  feasibility, 8 nodes a byte, little-endian (only
                       when some score column lives on the host)

over the chunk's first m pods.  The first-fail index is the full packed
word shifted by code_bits and the sums are int64, as the JAX package's
host tally computes them (ChunkAttribution._tally_chunk, replay.py:739);
the JAX function's int32 casts drop the index under p64 and wrap raws
past int32 (ROADMAP Queue C).

For tensors on the card the wrapper launches the kernel once on
PyTorch's current stream (the chunk totals zeroed on that stream just
before it), without synchronising, in the shape `att_shape` plans (W
warps a pod, P pods a CTA; `_warps=` and `_pods=` force them, and
`chunk_attribution.shape` records the last launch's), and adds one to
`launches`; for tensors on the CPU it runs the plain version.  There is
no fallback: a failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import step as kstep

MAX_F, MAX_Q = 16, 8
ATT_WARPS = (1, 2, 4, 8)   # warps a pod the kernel takes
ATT_PODS = (1, 2, 4, 8)    # pods a CTA
ATT_MAX_WARPS = 8          # a CTA's warps (csrc/attribution.cu ATT_MAX_WARPS)
ATT_IN_FLIGHT = 2048       # warps a launch aims to run at once: about 16 an SM of 132
ATT_NODES_A_WARP = 1024    # a warp of a pod takes at least this many nodes
ATT_SMEM = 48 * 1024       # the pods' bitmaps: the default dynamic shared memory
_GROUP_CODE = {"raw8": 1, "raw16": 2, "raw32": 3}
_P = ctypes.c_void_p


class AttArgs(ctypes.Structure):
    """csrc/attribution.cu `AttArgs`."""

    _fields_ = [
        *[(name, _P) for name in (
            "packed", "raw8", "raw16", "raw32", "fc", "fskip", "sskip",
            "s_sum", "feas_packed", "totals")],
        ("col_group", ctypes.c_int * MAX_Q),
        ("col_row", ctypes.c_int * MAX_Q),
        ("col_scorer", ctypes.c_int * MAX_Q),
        *[(name, ctypes.c_int) for name in (
            "c", "n", "m", "f", "q", "s8", "s16", "s32",
            "pack_bytes", "code_bits", "raw32_bytes", "want_pack", "warps", "pods")],
    ]


def att_shape(c: int, n: int, f: int, q: int) -> tuple[int, int]:
    """The launch shape of a chunk of c pods x n nodes with f filters and q
    device score columns -> (W warps a pod, P pods a CTA).  W doubles from 1
    while the launch has fewer than ATT_IN_FLIGHT warps and each warp keeps
    at least ATT_NODES_A_WARP nodes (up to 8); P makes a CTA at least four
    warps, halved while the pods' bitmaps (ceil(n / 32) words each) pass
    ATT_SMEM.  f and q only bound the kernel (16 and 8)."""
    if c < 1 or n < 0 or not 0 <= f <= MAX_F or not 0 <= q <= MAX_Q:
        raise ValueError(f"chunk_attribution: {c} pods, {n} nodes, {f} filters, {q} device "
                         f"score columns (the kernel takes {MAX_F} and {MAX_Q})")
    words = (n + 31) // 32
    if 4 * words > ATT_SMEM:
        raise ValueError(f"chunk_attribution: {n} nodes, a bitmap past {ATT_SMEM} bytes")
    w = 1
    while w < ATT_WARPS[-1] and c * w < ATT_IN_FLIGHT and n >= 2 * w * ATT_NODES_A_WARP:
        w *= 2
    pods = max(1, 4 // w)
    while pods > 1 and pods * 4 * words > ATT_SMEM:
        pods //= 2
    return w, pods


def chunk_attribution_plain(packed, raw8, raw16, raw32, fc, fskip_c, sskip_c,
                            m: int, code_bits: int, dev_cols: tuple,
                            want_pack: bool) -> dict:
    """The attribution of one chunk in plain PyTorch (module doc).

    packed [C, N]; raw8/raw16/raw32 [C, S_g, N]; fc [C]; fskip_c [F, C]
    and sskip_c [S, C] bool; dev_cols: (scorer index, group, row) of each
    score column on the device."""
    c, n = packed.shape
    dev = packed.device
    valid = torch.arange(c, device=dev) < m
    ffp = packed.to(torch.int64) >> code_bits
    feas = (ffp == 0) & valid[:, None]
    feas_cnt = feas.sum(1)
    out = {}
    f = fskip_c.shape[0]
    if f:
        fidx = torch.arange(1, f + 1, device=dev)[:, None, None]
        rej_pp = ((ffp[None] == fidx) & valid[None, :, None]).sum(2)      # [F, C]
        out["f_rejects"] = rej_pp.sum(1)
        suffix = rej_pp.flip(0).cumsum(0).flip(0)
        out["f_evaluated"] = torch.where(fskip_c, 0, feas_cnt[None] + suffix).sum(1)
    if dev_cols:
        raws = {"raw8": raw8, "raw16": raw16, "raw32": raw32}
        scored = (fc > 1) & valid
        sums, evaluated = [], []
        for s, group, row in dev_cols:
            s_on = scored & ~sskip_c[s]
            x = raws[group][:, row, :].to(torch.int64)
            sums.append(torch.where(feas & s_on[:, None], x, 0).sum(1))
            evaluated.append(torch.where(s_on, feas_cnt, 0).sum())
        out["s_sums"] = torch.stack(sums, 1)
        out["s_evaluated"] = torch.stack(evaluated)
    if want_pack:
        nb = (n + 7) // 8
        bits = torch.zeros((c, nb * 8), dtype=torch.int64, device=dev)
        bits[:, :n] = feas
        weights = torch.tensor([1 << k for k in range(8)], dtype=torch.int64, device=dev)
        out["feas_packed"] = (bits.view(c, nb, 8) * weights).sum(-1).to(torch.uint8)
    return out


def _check(name: str, t: torch.Tensor, dev, dtype=None, shape=None) -> None:
    if t.device != dev or not t.is_contiguous() or (dtype is not None and t.dtype != dtype) \
            or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"chunk_attribution {name}: {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}, contiguous {t.is_contiguous()}")


def _att_lib() -> ctypes.CDLL:
    from . import build

    lib = build.load("attribution")
    if lib.kss_att_args_size() != ctypes.sizeof(AttArgs):
        raise RuntimeError("AttArgs layout differs between csrc/attribution.cu and "
                           "kernels/attribution.py")
    return lib


def chunk_attribution(packed, raw8, raw16, raw32, fc, fskip_c, sskip_c,
                      m: int, code_bits: int, dev_cols: tuple,
                      want_pack: bool, _warps: int = 0, _pods: int = 0) -> dict:
    """One chunk's attribution (module doc).  CUDA tensors: the kernel's
    one launch, in att_shape's shape unless `_warps` / `_pods` force W / P;
    CPU tensors: chunk_attribution_plain."""
    dev = packed.device
    if dev.type == "cpu":
        return chunk_attribution_plain(packed, raw8, raw16, raw32, fc, fskip_c, sskip_c,
                                       m, code_bits, dev_cols, want_pack)
    if dev.type != "cuda":
        raise ValueError(f"chunk_attribution: unsupported device {dev}")
    c, n = packed.shape
    f, q = fskip_c.shape[0], len(dev_cols)
    warps, pods = att_shape(c, n, f, q)
    warps, pods = _warps or warps, _pods or pods
    if warps not in ATT_WARPS or pods not in ATT_PODS or warps * pods > ATT_MAX_WARPS \
            or pods * 4 * ((n + 31) // 32) > ATT_SMEM:
        raise ValueError(f"chunk_attribution: {warps} warps a pod, {pods} pods a CTA at "
                         f"{n} nodes")
    pack_bytes = packed.element_size()
    if pack_bytes not in (1, 2, 4, 8) or packed.dtype.is_floating_point:
        raise ValueError(f"chunk_attribution: packed words of {packed.dtype}")
    _check("packed", packed, dev)
    _check("raw8", raw8, dev, torch.int8)
    _check("raw16", raw16, dev, torch.int16)
    if raw32.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"chunk_attribution raw32: {raw32.dtype}")
    _check("raw32", raw32, dev)
    for name, t in (("raw8", raw8), ("raw16", raw16), ("raw32", raw32)):
        if t.shape[0] != c or t.shape[2] != n:
            raise ValueError(f"chunk_attribution {name}: {tuple(t.shape)} for [{c}, ., {n}]")
    _check("fc", fc, dev, torch.int32, (c,))
    _check("fskip", fskip_c, dev, torch.bool, (f, c))
    _check("sskip", sskip_c, dev, torch.bool, (sskip_c.shape[0], c))
    groups = {"raw8": raw8, "raw16": raw16, "raw32": raw32}
    for s, group, row in dev_cols:
        if not (0 <= s < sskip_c.shape[0] and 0 <= row < groups[group].shape[1]):
            raise ValueError(f"chunk_attribution: column {(s, group, row)} out of range")

    lib = _att_lib()
    s_sum = torch.empty((c, q), dtype=torch.int64, device=dev)
    totals = torch.empty(2 * f + q, dtype=torch.int64, device=dev)  # zeroed by the launch
    out = {"f_rejects": totals[:f], "f_evaluated": totals[f:2 * f],
           "s_sums": s_sum, "s_evaluated": totals[2 * f:]}
    if want_pack:
        out["feas_packed"] = torch.empty((c, (n + 7) // 8), dtype=torch.uint8, device=dev)

    a = AttArgs()
    for name, t in (("packed", packed), ("raw8", raw8), ("raw16", raw16), ("raw32", raw32),
                    ("fc", fc), ("fskip", fskip_c), ("sskip", sskip_c), ("s_sum", s_sum),
                    ("totals", totals)):
        setattr(a, name, t.data_ptr())
    a.feas_packed = out["feas_packed"].data_ptr() if want_pack else None
    for k, (s, group, row) in enumerate(dev_cols):
        a.col_group[k], a.col_row[k], a.col_scorer[k] = _GROUP_CODE[group], row, s
    a.c, a.n, a.m, a.f, a.q = c, n, min(max(int(m), 0), c), f, q
    a.s8, a.s16, a.s32 = raw8.shape[1], raw16.shape[1], raw32.shape[1]
    a.pack_bytes, a.code_bits = pack_bytes, code_bits
    a.raw32_bytes, a.want_pack = raw32.element_size(), int(want_pack)
    a.warps, a.pods = warps, pods
    kstep.check_launch("chunk_attribution",
                       lib.kss_chunk_attribution(ctypes.byref(a), kstep.stream_of(dev)))
    chunk_attribution.launches += 1
    chunk_attribution.shape = (warps, pods)
    if not f:
        del out["f_rejects"], out["f_evaluated"]
    if not q:
        del out["s_sums"], out["s_evaluated"]
    return out


chunk_attribution.launches = 0
chunk_attribution.shape = None
