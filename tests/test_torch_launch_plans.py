"""The host-side launch plans of B7 and B8, and the layouts they share
with csrc/, on the CPU:

* kernels/attribution.py `att_shape`: B7's (W warps a pod, P pods a CTA)
  from (C, N, F, Q), against a table worked out by hand at and around its
  boundaries (the warps in flight, the nodes a warp, the bitmaps' shared
  memory), and its refusals;
* kernels/gang.py `quorum_tables` / `quorum_path`: where B8 keeps its
  tables from (n, G), against a hand-computed table at the shared-memory
  boundary;
* the ctypes `AttArgs` against the C struct of csrc/attribution.cu, and
  `quorum_tables` against csrc/gang.cu's `quorum_table_ints`, both
  compiled by the host compiler;
* both wrappers on CPU tensors: the plain version, whatever shape or path
  is forced, and no launch counted.
"""

import ctypes
import re
import subprocess

import numpy as np
import pytest
import torch

import kube_scheduler_simulator_tpu_torch.framework  # noqa: F401 (import order)
from kube_scheduler_simulator_tpu_torch.framework.gang import quorum_slice_plain
from kube_scheduler_simulator_tpu_torch.kernels import attribution as katt
from kube_scheduler_simulator_tpu_torch.kernels import gang as kgang

CSRC = katt.__file__.rsplit("/", 2)[0] + "/csrc"


# ------------------------------------------------ B7: att_shape

# (C, N, F, Q) -> (W, P).  W doubles while C * W < 2,048 and N >= 2 W x
# 1,024; P = max(1, 4 // W), halved while P bitmaps of ceil(N / 32) words
# pass 48 KB.
ATT_TABLE = [
    ((512, 5000, 6, 3), (4, 1)),      # config 5's chunk
    ((512, 5000, 12, 8), (4, 1)),     # the default profile's: F and Q do not move it
    ((512, 4096, 6, 3), (4, 1)),      # N = 4 x 1,024: W reaches 4
    ((512, 4095, 6, 3), (2, 2)),      # one node short: W stays 2
    ((512, 2048, 6, 3), (2, 2)),
    ((512, 2047, 6, 3), (1, 4)),
    ((1024, 5000, 6, 3), (2, 2)),     # C x W reaches 2,048 at W = 2
    ((2048, 5000, 6, 3), (1, 4)),     # already 2,048 warps at W = 1
    ((256, 8192, 6, 3), (8, 1)),      # W = 8, the most
    ((256, 8191, 6, 3), (4, 1)),
    ((40, 1037, 12, 4), (1, 4)),      # the card tests' small chunk
    ((1, 1, 0, 0), (1, 4)),
    ((3000, 200_000, 6, 3), (1, 1)),  # 4 x 25,000 B and 2 x 25,000 B pass 48 KB
    ((2048, 100_000, 6, 3), (1, 2)),  # 4 x 12,500 B passes it, 2 x does not
    ((1, 393_216, 16, 8), (8, 1)),    # one bitmap of exactly 48 KB
]


@pytest.mark.parametrize("args,want", ATT_TABLE)
def test_att_shape_table(args, want):
    assert katt.att_shape(*args) == want


@pytest.mark.parametrize("args", [(0, 5000, 6, 3), (512, 5000, -1, 3), (-1, 5000, 17, 3),
                                  (512, 5000, 6, -1), (512, -1, 6, 3)])
def test_att_shape_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        katt.att_shape(*args)


def test_att_shape_always_fits_the_kernel():
    """Over a grid of chunk and fleet sizes the plan is a shape the kernel
    takes: W and P from their sets, at most 8 warps a CTA, the bitmaps
    within 48 KB; and W is the largest such that the launch has under
    2,048 warps or just reaches them."""
    for c in (1, 7, 64, 255, 256, 512, 513, 2047, 4096):
        for n in (1, 31, 1023, 1024, 2049, 4999, 5000, 9000, 50_000, 300_000):
            w, p = katt.att_shape(c, n, 8, 4)
            assert w in katt.ATT_WARPS and p in katt.ATT_PODS
            assert w * p <= katt.ATT_MAX_WARPS
            assert p * 4 * ((n + 31) // 32) <= katt.ATT_SMEM
            grow = w < 8 and c * w < katt.ATT_IN_FLIGHT and n >= 2 * w * katt.ATT_NODES_A_WARP
            assert not grow, (c, n, w)


# ------------------------------------------------ B8: quorum_path

# (n, G) -> (bytes, path): 4 x (4 G + n + 2 ceil(n / 32)) bytes, shared
# while at most 224 KB (229,376 B, 57,344 ints).
QUORUM_TABLE = [
    ((10_000, 1_250), (62_504, "shared")),       # phase 18's slice
    ((512, 260), (6_336, "shared")),             # a commit range of phase 20's wave
    ((10_000, 100_000), (1_642_504, "global")),  # G past shared memory
    ((40_000, 300), (174_800, "shared")),        # two tiles of the words' scan
    ((1, 1), (28, "shared")),
    ((32, 14_327), (229_368, "shared")),
    ((32, 14_328), (229_384, "global")),
    ((33, 14_327), (229_380, "global")),         # a pod more, and a second word
    ((53_966, 1), (229_376, "shared")),          # exactly the limit, n nearly alone
    ((53_967, 1), (229_380, "global")),
]


@pytest.mark.parametrize("args,want", QUORUM_TABLE)
def test_quorum_path_table(args, want):
    assert (kgang.quorum_tables(*args), kgang.quorum_path(*args)) == want


# ------------------------------------------------ layouts shared with csrc/

def _compile_run(tmp_path, name: str, body: str) -> list[str]:
    src = tmp_path / f"{name}.cpp"
    src.write_text(body)
    exe = tmp_path / name
    subprocess.run(["g++", "-std=c++17", str(src), "-o", str(exe)], check=True)
    return subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout.split()


def test_att_args_layout_matches_the_c_struct(tmp_path):
    """csrc/attribution.cu's AttArgs (its defines and the struct, compiled
    by the host compiler) has the ctypes mirror's size and every field's
    offset."""
    text = open(f"{CSRC}/attribution.cu").read()
    defines = "\n".join(re.findall(r"^#define ATT_\w+ .*$", text, re.M))
    struct = re.search(r"^struct AttArgs \{.*?^\};", text, re.M | re.S).group(0)
    fields = [f for f, _t in katt.AttArgs._fields_]
    out = _compile_run(tmp_path, "att_layout", (
        f"#include <cstddef>\n#include <cstdio>\n{defines}\n{struct}\n"
        "int main() {\n  printf(\"%zu\\n\", sizeof(AttArgs));\n"
        + "".join(f'  printf("%zu\\n", offsetof(AttArgs, {f}));\n' for f in fields)
        + "}\n"))
    assert int(out[0]) == ctypes.sizeof(katt.AttArgs)
    for f, off in zip(fields, out[1:], strict=True):
        assert int(off) == getattr(katt.AttArgs, f).offset, f
    assert f"#define ATT_MAX_WARPS {katt.ATT_MAX_WARPS} " in text


def test_quorum_tables_match_the_c_function(tmp_path):
    """kernels/gang.py quorum_tables is 4 x csrc/gang.cu quorum_table_ints
    over a grid of (n, G)."""
    text = open(f"{CSRC}/gang.cu").read()
    fn = re.search(r"^__host__ __device__ inline long long quorum_table_ints.*?^\}", text,
                   re.M | re.S).group(0).replace("__host__ __device__ ", "")
    grid = [(n, g) for n in (1, 31, 32, 33, 10_000, 53_967) for g in (1, 260, 1_250, 100_000)]
    out = _compile_run(tmp_path, "quorum_tables", (
        f"#include <cstdio>\n{fn}\nint main() {{\n"
        + "".join(f'  printf("%lld\\n", quorum_table_ints({n}, {g}));\n' for n, g in grid)
        + "}\n"))
    assert [4 * int(x) for x in out] == [kgang.quorum_tables(n, g) for n, g in grid]


# ------------------------------------------------ the wrappers on the CPU

def test_wrappers_on_cpu_run_the_plain_versions_whatever_is_forced():
    rng = np.random.default_rng(3)
    c, n = 6, 45
    packed = torch.from_numpy(np.where(rng.random((c, n)) < 0.5, 0,
                                       rng.integers(1, 5, (c, n)) << 8).astype(np.uint16))
    raw16 = torch.from_numpy(rng.integers(-99, 99, (c, 1, n)).astype(np.int16))
    args = (packed, torch.zeros((c, 0, n), dtype=torch.int8), raw16,
            torch.zeros((c, 0, n), dtype=torch.int32),
            torch.from_numpy(rng.integers(0, 4, c).astype(np.int32)),
            torch.from_numpy(rng.random((4, c)) < 0.3), torch.zeros((1, c), dtype=torch.bool),
            c - 1, 8, ((0, "raw16", 0),), True)
    want = katt.chunk_attribution_plain(*args)
    att0, q0 = katt.chunk_attribution.launches, kgang.quorum_slice.launches
    for w, p in ((1, 1), (8, 1), (2, 4)):
        got = katt.chunk_attribution(*args, _warps=w, _pods=p)
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    gid = np.where(rng.random(50) < 0.7, rng.integers(0, 5, 50), -1).astype(np.int32)
    rows = (gid, rng.integers(-1, 9, 50).astype(np.int32), rng.integers(0, 3, 5).astype(np.int32),
            rng.integers(1, 6, 5).astype(np.int32))
    admit, wave, wait = quorum_slice_plain(*(torch.from_numpy(a) for a in rows))
    for path in (None, "shared", "global"):
        out = kgang.quorum_slice(torch.from_numpy(np.concatenate(rows)), 50, 5, _path=path)
        assert torch.equal(out, torch.cat([admit.to(torch.int32), wave, wait.to(torch.int32)]))
    assert (katt.chunk_attribution.launches, kgang.quorum_slice.launches) == (att0, q0)
