"""Wrapper of kernel B8, `quorum_slice` (csrc/gang.cu): the gang-quorum
pass over one pending slice.

`quorum_slice(packed_in, n, g)` takes the slice's four int32 rows packed
into one tensor, [gid (n), selected (n), already (g), min_member (g)],
so the caller's host-to-device copy is one transfer, and returns one
int32 tensor [admit (g), wave (g), wait (n)], one copy back:

  * for a tensor on the card it launches the hand-written kernel once,
    one block, on PyTorch's current stream, without synchronising, and
    adds one to `quorum_slice.launches`;
  * for a tensor on the CPU it runs the plain version,
    framework/gang.py `quorum_slice_plain`.

n == 0 or g == 0 is the caller's: the reference answers it without
computing (framework/gang.py).  A failed build or launch raises.
"""

from __future__ import annotations

import torch

from . import step as kstep


def quorum_slice(packed_in: torch.Tensor, n: int, g: int) -> torch.Tensor:
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
    from . import build

    lib = build.load("gang")
    out = torch.empty(2 * g + n, dtype=torch.int32, device=dev)
    scratch = torch.empty(n + 3 * g + 2, dtype=torch.int32, device=dev)
    err = lib.kss_quorum_slice(packed_in.data_ptr(), n, g, out.data_ptr(), scratch.data_ptr(),
                               kstep.stream_of(dev))
    kstep.check_launch("quorum_slice", err)
    quorum_slice.launches += 1
    return out


quorum_slice.launches = 0
