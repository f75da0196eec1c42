// Host threads that play a "dp" row's cards for tests/test_torch_relay.py:
// each pod slot a thread that does what csrc/scope.cuh PeerScope does on
// the card, over plain host buffers of its layout.  For each epoch e it
// publishes this card's entry into every buffer of the row (its values,
// then the epoch with a release store), then waits until every card's
// entry of its own buffer (the inbox) holds e (acquire loads) and checks
// that each holds e exactly and that card's values of e.  The relay
// (csrc/relay.cpp) carries the entries between the processes.  A wait
// past `bound_ms` writes the error word as the kernel does (1 + the card
// it waited for); unlike the kernel, a wait that finds the error word set
// (the relay lost a connection) stops at once.
#include <atomic>
#include <chrono>
#include <cstdint>
#include <thread>
#include <vector>

#define XHEAD 16
#define XW 16

namespace {

uint64_t* entry(uint64_t* buf, int cards, int slot, int parity, int col) {
  return buf + XHEAD + ((long long)(slot * 2 + parity) * cards + col) * XW;
}

uint64_t value(int col, int slot, long long e, int q) {
  return ((uint64_t)e * 1000003u + (uint64_t)slot * 131u + (uint64_t)col * 17u + (uint64_t)q) ^
         0x9e3779b97f4a7c15ull;
}

enum { OK = 0, BOUND = 1, ERROR_WORD = 2, VALUES = 3, ORDER = 4 };

void play_slot(uint64_t* const* bufs, int cards, int card0, int col, int slot, long long base,
               long long epochs, long long bound_ms, long long* out) {
  uint64_t* inbox = bufs[col];
  for (long long e = base + 1; e <= base + epochs; ++e) {
    const int b = (int)(e & 1);
    for (int k = 0; k < cards; ++k) {
      uint64_t* x = entry(bufs[k], cards, slot, b, col);
      for (int q = 1; q < XW; ++q) __atomic_store_n(x + q, value(col, slot, e, q), __ATOMIC_RELAXED);
      __atomic_store_n(x, (uint64_t)e, __ATOMIC_RELEASE);
    }
    for (int j = 0; j < cards; ++j) {
      uint64_t* y = entry(inbox, cards, slot, b, j);
      const auto t0 = std::chrono::steady_clock::now();
      uint64_t got;
      while ((got = __atomic_load_n(y, __ATOMIC_ACQUIRE)) < (uint64_t)e) {
        std::this_thread::yield();  // the tests' processes share a few cores
        if (__atomic_load_n(inbox, __ATOMIC_ACQUIRE) != 0) {
          out[0] = ERROR_WORD;
          out[1] = e;
          return;
        }
        if (std::chrono::steady_clock::now() - t0 > std::chrono::milliseconds(bound_ms)) {
          uint64_t zero = 0;
          __atomic_compare_exchange_n(inbox, &zero, (uint64_t)(1 + card0 + j), false,
                                      __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST);
          out[0] = BOUND;
          out[1] = e;
          return;
        }
      }
      if (got != (uint64_t)e) {
        out[0] = ORDER;
        out[1] = e;
        return;
      }
      for (int q = 1; q < XW; ++q) {
        if (__atomic_load_n(y + q, __ATOMIC_RELAXED) != value(j, slot, e, q)) {
          out[0] = VALUES;
          out[1] = e;
          return;
        }
      }
    }
  }
  out[0] = OK;
  out[1] = base + epochs;
}

}  // namespace

// The card of column `col` of a row of `cards` cards whose first card is
// mesh index `card0`: `bufs[k]` is card k's buffer as this card writes it
// (bufs[col] its own, the inbox).  Epochs base + 1 .. base + epochs on
// `slots` slots, a thread each.  out[2 s], out[2 s + 1]: slot s's outcome
// (OK, BOUND, ERROR_WORD, VALUES, ORDER) and the epoch it ended at.
// -> the worst outcome.
extern "C" int kss_play(uint64_t* const* bufs, int cards, int card0, int col, int slots,
                        long long base, long long epochs, long long bound_ms, long long* out) {
  std::vector<std::thread> threads;
  for (int s = 0; s < slots; ++s)
    threads.emplace_back(play_slot, bufs, cards, card0, col, s, base, epochs, bound_ms, out + 2 * s);
  for (auto& t : threads) t.join();
  long long worst = 0;
  for (int s = 0; s < slots; ++s) worst = out[2 * s] > worst ? out[2 * s] : worst;
  return (int)worst;
}
