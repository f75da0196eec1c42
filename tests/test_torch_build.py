"""kernels/build.py with a stand-in compiler: what it compiles, and when.

The stand-in takes nvcc's arguments, waits a little, writes the `-o`
file and logs its command line, so these tests run without the CUDA
toolkit: threads that build at once compile each library once, and the
phase clock's variant compiles only when it is asked for.
"""

import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest

from kube_scheduler_simulator_tpu_torch.kernels import build


@pytest.fixture
def nvcc_log(tmp_path, monkeypatch):
    """A stand-in nvcc in a fresh build directory -> its log: one line of
    arguments per compile."""
    log = tmp_path / "calls.log"
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "time.sleep(0.2)\n"
        f"with open({str(log)!r}, 'a') as f:\n"
        "    f.write(' '.join(sys.argv[1:]) + '\\n')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').write(b'stand-in')\n")
    script.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "_nvcc", lambda: str(script))
    return log


def _calls(log):
    return log.read_text().splitlines() if log.exists() else []


DEFAULT_STEMS = [s for s in build.SIGNATURES if s not in build.VARIANTS]


def test_threads_building_at_once_compile_each_library_once(nvcc_log):
    start = threading.Barrier(4, timeout=60)

    def run(_):
        start.wait()
        return build.build()

    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(run, range(4)))
    assert len(_calls(nvcc_log)) == len(DEFAULT_STEMS)
    for res in results:
        assert sorted(res) == sorted(DEFAULT_STEMS)
        assert all(r.path.exists() for r in res.values())
    assert sum(r.compiled for res in results for r in res.values()) == len(DEFAULT_STEMS)


def test_the_clock_variant_compiles_only_when_asked_for(nvcc_log):
    built = build.build()
    assert "step_clock" not in built
    assert not any("KSS_PHASE_CLOCK" in c for c in _calls(nvcc_log))
    clock = build.build(["step_clock"])
    assert list(clock) == ["step_clock"] and clock["step_clock"].compiled
    calls = _calls(nvcc_log)
    assert len(calls) == len(DEFAULT_STEMS) + 1
    assert "-DKSS_PHASE_CLOCK" in calls[-1] and calls[-1].endswith("step.cu")
    assert not build.build()["step"].compiled  # already there: nothing compiles again
