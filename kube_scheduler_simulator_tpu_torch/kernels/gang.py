"""Wrapper of kernel B8, `quorum_slice` (csrc/gang.cu): the gang-quorum
pass over one pending slice.

`quorum_slice(packed_in, n, g)` takes the slice's four int32 rows packed
into one tensor, [gid (n), selected (n), already (g), min_member (g)],
so the caller's host-to-device copy is one transfer, and returns one
int32 tensor [admit (g), wave (g), wait (n)], one copy back:

  * for a tensor on the card it launches the hand-written kernel once,
    one CTA, on PyTorch's current stream, without synchronising, and adds
    one to `quorum_slice.launches`.  Its tables (16 bytes a group, 4 a
    pod and 8 per 32 pods: `quorum_tables`) live in shared memory where
    they fit (`quorum_path` -> "shared"), else in device memory
    ("global"); `_path=` forces either, and `quorum_slice.path` records
    the last launch's;
  * for a tensor on the CPU it runs the plain version,
    framework/gang.py `quorum_slice_plain`.

n == 0 or g == 0 is the caller's: the reference answers it without
computing (framework/gang.py).  A failed build or launch raises.
"""

from __future__ import annotations

import torch

from . import step as kstep

QUORUM_PATHS = ("shared", "global")
# the shared path's tables at most: the card's 227 KB of opt-in shared
# memory a CTA, less room for the kernel's static part
QUORUM_SMEM = 224 * 1024


def quorum_tables(n: int, g: int) -> int:
    """Bytes of the kernel's tables for a slice of n pods and g groups
    (csrc/gang.cu quorum_table_ints)."""
    return 4 * (4 * g + n + 2 * ((n + 31) // 32))


def quorum_path(n: int, g: int) -> str:
    """Where a launch keeps its tables: "shared" while they fit
    QUORUM_SMEM, else "global"."""
    return "shared" if quorum_tables(n, g) <= QUORUM_SMEM else "global"


def quorum_slice(packed_in: torch.Tensor, n: int, g: int, _path: str | None = None
                 ) -> torch.Tensor:
    """[2n + 2g] int32 -> [2g + n] int32 (module doc)."""
    from ..framework.gang import quorum_slice_plain

    if packed_in.dtype != torch.int32 or tuple(packed_in.shape) != (2 * n + 2 * g,) \
            or not packed_in.is_contiguous():
        raise ValueError(f"quorum_slice: input {packed_in.dtype} {tuple(packed_in.shape)}, "
                         f"expected int32 ({2 * n + 2 * g},) contiguous")
    if n <= 0 or g <= 0:
        raise ValueError("quorum_slice: empty slice or no groups (the caller answers those)")
    dev = packed_in.device
    if dev.type == "cpu":
        admit, wave, wait = quorum_slice_plain(
            packed_in[:n], packed_in[n:2 * n], packed_in[2 * n:2 * n + g], packed_in[2 * n + g:])
        return torch.cat([admit.to(torch.int32), wave, wait.to(torch.int32)])
    kstep.check_device("quorum_slice", dev, {"in": packed_in})
    path = _path or quorum_path(n, g)
    if path not in QUORUM_PATHS or (path == "shared" and quorum_tables(n, g) > QUORUM_SMEM):
        raise ValueError(f"quorum_slice: path {path!r} for n={n}, G={g} "
                         f"({quorum_tables(n, g)} bytes of tables)")
    from . import build

    lib = build.load("gang")
    out = torch.empty(2 * g + n, dtype=torch.int32, device=dev)
    scratch = None if path == "shared" else torch.empty(
        quorum_tables(n, g) // 4, dtype=torch.int32, device=dev)
    err = lib.kss_quorum_slice(packed_in.data_ptr(), n, g, out.data_ptr(),
                               None if scratch is None else scratch.data_ptr(),
                               int(path == "shared"), kstep.stream_of(dev))
    kstep.check_launch("quorum_slice", err)
    quorum_slice.launches += 1
    quorum_slice.path = path
    return out


quorum_slice.launches = 0
quorum_slice.path = None
