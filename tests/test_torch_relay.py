"""The host relay of a mesh across hosts (B12c across hosts:
csrc/relay.cpp, kernels/relay.py) on the CPU.

The relay is plain C++, built here with g++ (kernels/build.py
HOST_SIGNATURES).  Two spawned processes pose as two hosts
(`initialize_distributed(_host=...)`); in each, host threads play one
card of a row of two (tests/torch_relay_cards.cpp, compiled here with
g++): they publish entries into plain host buffers of PeerScope's layout,
the epoch last, and wait for the other card's entries in their own
buffer, and the two relays carry the entries between the processes over
TCP.  Checked: every epoch's values arrive whole and in order, over
thousands of epochs, both parities and 8 slots, and each side's sent
count equals the other's received count; a peer that stops sending trips
the waiter's bound (the kernel's error word, no lost connection); a peer
that raises mid-run closes its connection without a goodbye, the relay
writes the error word, and the waiter raises naming that process and
its host well before its bound, not hanging.
"""

import ctypes
import subprocess
from pathlib import Path

import pytest

import torch_mesh_procs_workers as workers
from kube_scheduler_simulator_tpu_torch.kernels import build
from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
from kube_scheduler_simulator_tpu_torch.parallel.distributed import _spawn

SLOTS, EPOCHS = 8, 3000
DEADLINE_S = 90.0
OK, BOUND, ERROR_WORD = 0, 1, 2  # tests/torch_relay_cards.cpp's outcomes


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The relay built (before the workers load it) and the card harness
    compiled -> the harness's path."""
    build.load("relay")
    out = tmp_path_factory.mktemp("relay") / "libcards.so"
    src = Path(__file__).resolve().parent / "torch_relay_cards.cpp"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-o", str(out),
                    str(src)], check=True, capture_output=True)
    return str(out)


def test_relay_layout_is_peer_scopes():
    from kube_scheduler_simulator_tpu_torch.kernels.relay import load_lib

    lib = load_lib()
    head, width, cards = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    msg = lib.kss_relay_layout(ctypes.byref(head), ctypes.byref(width), ctypes.byref(cards))
    assert (head.value, width.value, cards.value) == (kmesh.XHEAD, kmesh.XW, kmesh.MAX_CARDS)
    assert msg == 8 + 8 * kmesh.XW  # (slot, parity) and the entry's words


@pytest.mark.parametrize("n,slots,epochs", [(2, SLOTS, EPOCHS), (4, 2, 1000)],
                         ids=["row2", "row4"])
def test_relay_carries_every_epoch_whole_and_in_order(harness, n, slots, epochs):
    """A row of 2 cards, and of 4 (each relay connected to 3 peers, two
    processes a faked host)."""
    got = _spawn(workers.relay_worker, n, ("ordered", harness, slots, epochs, n),
                 deadline_s=DEADLINE_S)
    assert not any(r["jax"] for r in got), "a worker imported JAX"
    for rank, r in enumerate(got):
        assert r["outcomes"] == [[OK, epochs]] * slots, (rank, r["outcomes"])
        assert (r["word"], r["word_after_stop"]) == (0, 0), r
        assert r["status"]["lost"] is None, r
        # every epoch of every slot's entry to every peer, one message each
        assert r["status"]["sent"] == r["status"]["received"] == slots * epochs * (n - 1), r


def test_a_silent_peer_trips_the_bound(harness):
    got = _spawn(workers.relay_worker, 2, ("silent", harness, SLOTS, 400),
                 deadline_s=DEADLINE_S)
    assert got[1]["outcomes"] == [[OK, 200]] * SLOTS
    # process 0 waited for card 1's epoch 201 past its bound: the first
    # slot to pass it wrote the error word, on which the others stopped
    outcomes = got[0]["outcomes"]
    assert all(e == 201 and o in (BOUND, ERROR_WORD) for o, e in outcomes), outcomes
    assert [BOUND, 201] in outcomes, outcomes
    assert got[0]["word"] == 1 + 1
    assert all(r["status"]["lost"] is None for r in got)


def test_a_peer_that_raises_closes_its_connection(harness):
    """Process 1 raises after half the epochs; its connection closes with
    no goodbye, process 0's relay writes the error word (the relay's
    form: it lost card 1), and process 0 raises naming process 1 and its
    host long before its 60 s bound."""
    with pytest.raises(RuntimeError) as e:
        _spawn(workers.relay_worker, 2, ("raises", harness, SLOTS, 400),
               deadline_s=DEADLINE_S)
    msg = str(e.value)
    assert "worker 1 of 2 failed" in msg and "process 1 raises mid-run" in msg, msg
    assert "worker 0 of 2 failed" in msg, msg
    assert f"outcome {ERROR_WORD}: card 0 (process 0 on host-0:cpu) lost its relay connection " \
           "to card 1 (process 1 on host-1:cpu)" in msg, msg
    waited = float(msg.split("RuntimeError: after ")[1].split(" s,")[0])
    assert waited < 10.0, msg
