"""B3's plain version in the port, on the CPU: `_oracle_core`
(kernels/spec.py), the twin the card's oracle kernel (csrc/oracle.cu)
is held to, against the JAX package's `_oracle_core` exactly, on the
synthetic batches the card tests and chip_smoke.py use
(chip_smoke.oracle_batch: all accepted, a conflict at k = 1, one only at
k = B - 1, every row rejected, random), at every pack width, with and
without pad rows; and the launch plan's CTA counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kube_scheduler_simulator_tpu.parallel.speculative import _oracle_core as j_oracle_core
from kube_scheduler_simulator_tpu_torch.framework.pipeline import PACK_MODES
from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

BATCHES = (1, 2, 7, 8, 31, 32, 33, 512)
N = 48


@pytest.mark.parametrize("kind", chip_smoke.ORACLE_KINDS)
@pytest.mark.parametrize("b", BATCHES)
def test_oracle_plain_matches_jax(b, kind):
    """_oracle_core == the JAX _oracle_core at every pack width, pad rows
    or none; the kinds that fix K give it (accepted and rejected B, first
    1, last B - 1)."""
    for p, (dtype, _, _) in enumerate(PACK_MODES.values()):
        for pads in (0, min(3, b - 1)):
            packed, reject, sel = chip_smoke.oracle_batch(kind, b, N, dtype, seed=b + p,
                                                          pads=pads)
            got = kspec._oracle_core(packed, reject, sel, b)
            jp = packed.to(torch.int64).numpy().astype(np.dtype(str(dtype).split(".")[1]))
            want = j_oracle_core(jnp.asarray(jp), jnp.asarray(reject.numpy()),
                                 jnp.asarray(sel.numpy()), b)
            assert got.dtype == torch.int32 and int(got) == int(want), (b, kind, dtype, pads)
            fixed = {"accepted": b, "rejected": b, "first": 1 if b > 1 else b,
                     "last": b - 1 if b > 1 else b}
            if kind in fixed and (pads == 0 or kind in ("accepted", "rejected")):
                assert int(got) == fixed[kind], (b, kind, dtype, pads)


@pytest.mark.parametrize("b,ctas", [(1, 1), (8, 1), (32, 1), (33, 2), (64, 2), (65, 4),
                                    (128, 4), (256, 8), (512, 16), (10_000, 16)])
def test_the_oracle_plan_grows_with_the_batch(b, ctas):
    """oracle_ctas: 32 rows a CTA, at most a cluster of 16."""
    assert kspec.oracle_ctas(b) == ctas
