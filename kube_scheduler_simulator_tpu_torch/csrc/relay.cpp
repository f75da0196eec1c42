// The host relay of a card mesh whose processes span hosts (B12c across
// hosts; kernels/relay.py, kernels/mesh.py Exchange).
//
// It replaces no TPU kernel: it is the transport under the B12b kernels
// (scope.cuh PeerScope) where the cards of a mesh have no peer memory,
// the counterpart of the DCN that XLA's all-reduces of
// kube_scheduler_simulator_tpu/parallel/mesh.py:130 `sharded_step` and
// :143 `speculative_scores` cross once `initialize_distributed` (:175)
// has laid the mesh across hosts.  Plain C++ and POSIX sockets: no CUDA,
// no Python, so a relay thread never takes the GIL or makes a CUDA call.
//
// The buffers.  A process holds one card of the mesh.  Its card's
// exchange buffer (the "inbox") and one "outbox" for each other card of
// its "dp" row are page-locked host memory mapped into the card
// (csrc/step.cu kss_mapped_alloc), each laid out as PeerScope's buffers
// are: KSS_XHEAD words, then [slots][2 parities][cards][KSS_XW].  The
// launch's PeerArgs.xbuf[own] is the inbox and xbuf[k] outbox k, so
// PeerScope::publish writes this card's column of every card's buffer
// (its own column of the inbox, and of each outbox) and PeerScope::await
// polls the inbox, unchanged.  The relay carries each outbox's entries to
// the process that holds that card and writes them into its inbox.
//
// The protocol.  One TCP connection a pair of processes of a row (made by
// kernels/relay.py, TCP_NODELAY).  While a launch is in flight (armed) the
// relay thread spins: it reads each outbox entry of this card's column
// whose slot the launch uses, and where its epoch (an acquire load: the
// card's st.release.sys makes the values visible first) is newer than the
// last it sent, it sends (slot, parity, epoch, values); it receives
// without blocking, and writes each received entry's values and then its
// epoch (a release store: the card's ld.acquire.sys then reads whole
// values) into the sender's column of the inbox.  Parked (no launch in
// flight) it sweeps the outboxes once, so that the last epochs of a launch
// that has ended go out, then blocks on its sockets: a peer's launch may
// start before this process's, and its entries are written as they come.
//
// Forwarding only the newest epoch of an entry loses nothing.  Card A
// publishes epoch e + 2 into its entry of card B's buffer (the same
// parity as e) only after its await(e + 1) saw every card of the row at
// e + 1; card B publishes e + 1 only after its await(e) saw A's e and its
// combine read A's values of e.  So when A's relay reads e + 2, B has
// consumed e, which A's relay had therefore sent: the relay sends every
// epoch of every entry, in order (so each side's sent count equals the
// other's received count), and the values of e stay in the outbox until
// they are sent.  A received epoch that does not grow is a protocol fault.
//
// Faults.  A closed connection (no goodbye), a short or bad message, or a
// failed send: the relay writes the inbox's error word, if it is still 0,
// to 1 + KSS_MAX_CARDS + the card it lost (1 + a card is the kernel's
// own word for a wait past its spin bound), records the card and errno,
// and drops the connection; kernels/mesh.py Exchange raises naming both
// processes and hosts.  A peer that stays silent is caught by the
// kernel's spin bound.  A relay that stops sends a goodbye first, so its
// peers close without an error.
#include <fcntl.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define KSS_MAX_CARDS 8  // scope.cuh
#define KSS_XW 16        // scope.cuh: 8-byte words an entry, the epoch first
#define KSS_XHEAD 16     // scope.cuh: words of a buffer's header, [0] the error word

namespace {

struct Msg {  // one entry on the wire; slot -1 is a goodbye
  int32_t slot;
  int32_t parity;
  uint64_t w[KSS_XW];  // w[0] the epoch
};
static_assert(sizeof(Msg) == 8 + 8 * KSS_XW, "Msg has no padding");

struct Peer {
  int fd;
  int card;          // its mesh index
  int col;           // its column in the row's buffers
  uint64_t* outbox;  // its card's buffer as this card writes it
  std::vector<uint64_t> last;  // [slots][2]: the last epoch sent
  std::vector<char> in;        // bytes of a message not yet whole
  std::vector<Msg> out;        // a sweep's messages
  bool open;
};

struct Relay {
  uint64_t* inbox;
  int card, cards, col, slots_total;
  std::vector<Peer> peers;
  std::atomic<int> armed{0};
  std::atomic<int> slots{1};
  std::atomic<bool> stop{false};
  std::atomic<long long> sent{0}, received{0}, lost{0}, err{0};
  int wake[2] = {-1, -1};
  std::thread thread;
};

uint64_t* entry(uint64_t* buf, const Relay& r, int slot, int parity, int col) {
  return buf + KSS_XHEAD + ((long long)(slot * 2 + parity) * r.cards + col) * KSS_XW;
}

void fail(Relay& r, Peer& p, int e) {
  if (!p.open) return;
  p.open = false;
  close(p.fd);
  p.fd = -1;
  r.err.store(e);
  long long none = 0;
  r.lost.compare_exchange_strong(none, 1 + p.card);
  uint64_t zero = 0;
  __atomic_compare_exchange_n(r.inbox, &zero, (uint64_t)(1 + KSS_MAX_CARDS + p.card), false,
                              __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST);
}

bool send_all(int fd, const void* data, size_t n) {
  const char* p = static_cast<const char*>(data);
  while (n > 0) {
    const ssize_t k = send(fd, p, n, MSG_NOSIGNAL);
    if (k < 0 && errno == EINTR) continue;
    if (k <= 0) return false;
    p += k;
    n -= (size_t)k;
  }
  return true;
}

// Every outbox entry of this card's column newer than the last sent, to
// its card's process.
void sweep(Relay& r) {
  const int slots = r.slots.load(std::memory_order_acquire);
  for (Peer& p : r.peers) {
    if (!p.open) continue;
    p.out.clear();
    for (int s = 0; s < slots; ++s) {
      for (int b = 0; b < 2; ++b) {
        const uint64_t* x = entry(p.outbox, r, s, b, r.col);
        const uint64_t e = __atomic_load_n(x, __ATOMIC_ACQUIRE);
        uint64_t& last = p.last[s * 2 + b];
        if (e <= last) continue;
        Msg m;
        m.slot = s;
        m.parity = b;
        m.w[0] = e;
        for (int q = 1; q < KSS_XW; ++q) m.w[q] = __atomic_load_n(x + q, __ATOMIC_RELAXED);
        p.out.push_back(m);
        last = e;
      }
    }
    if (p.out.empty()) continue;
    if (!send_all(p.fd, p.out.data(), p.out.size() * sizeof(Msg))) {
      fail(r, p, errno ? errno : EPIPE);
      continue;
    }
    r.sent.fetch_add((long long)p.out.size());
  }
}

// A received entry into the sender's column of the inbox, its epoch last.
bool deliver(Relay& r, Peer& p, const Msg& m) {
  if (m.slot == -1) {  // goodbye: the peer stopped
    p.open = false;
    close(p.fd);
    p.fd = -1;
    return true;
  }
  if (m.slot < 0 || m.slot >= r.slots_total || (m.parity != 0 && m.parity != 1)) return false;
  uint64_t* x = entry(r.inbox, r, m.slot, m.parity, p.col);
  if (m.w[0] <= __atomic_load_n(x, __ATOMIC_RELAXED)) return false;  // epochs only grow
  for (int q = 1; q < KSS_XW; ++q) __atomic_store_n(x + q, m.w[q], __ATOMIC_RELAXED);
  __atomic_store_n(x, m.w[0], __ATOMIC_RELEASE);
  r.received.fetch_add(1);
  return true;
}

void receive(Relay& r, Peer& p) {
  char buf[64 * sizeof(Msg)];
  for (;;) {
    const ssize_t k = recv(p.fd, buf, sizeof(buf), MSG_DONTWAIT);
    if (k < 0 && errno == EINTR) continue;
    if (k < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return;
    if (k <= 0) {  // closed without a goodbye, or an error
      fail(r, p, k == 0 ? ECONNRESET : errno);
      return;
    }
    p.in.insert(p.in.end(), buf, buf + k);
    size_t at = 0;
    while (p.in.size() - at >= sizeof(Msg)) {
      Msg m;
      memcpy(&m, p.in.data() + at, sizeof(Msg));
      at += sizeof(Msg);
      if (!deliver(r, p, m)) {
        fail(r, p, EPROTO);
        return;
      }
      if (!p.open) return;  // a goodbye
    }
    p.in.erase(p.in.begin(), p.in.begin() + (long)at);
  }
}

void run(Relay* r) {
  std::vector<pollfd> fds;
  std::vector<Peer*> of;
  while (!r->stop.load(std::memory_order_acquire)) {
    const bool armed = r->armed.load(std::memory_order_acquire) > 0;
    sweep(*r);
    fds.clear();
    of.clear();
    fds.push_back({r->wake[0], POLLIN, 0});
    for (Peer& p : r->peers) {
      if (!p.open) continue;
      fds.push_back({p.fd, POLLIN, 0});
      of.push_back(&p);
    }
    // armed: a look at the sockets and on; parked: block until a peer
    // sends, or arm / park / stop wakes the thread
    if (poll(fds.data(), fds.size(), armed ? 0 : -1) < 0) continue;
    if (fds[0].revents) {
      char drain[64];
      while (read(r->wake[0], drain, sizeof(drain)) > 0) {
      }
    }
    for (size_t i = 1; i < fds.size(); ++i)
      if (fds[i].revents) receive(*r, *of[i - 1]);
  }
  Msg bye{};
  bye.slot = -1;
  for (Peer& p : r->peers)
    if (p.open) send_all(p.fd, &bye, sizeof(bye));
}

// A full pipe (EAGAIN) has woken the thread already.
void wake(Relay* r) {
  const char c = 1;
  while (write(r->wake[1], &c, 1) < 0 && errno == EINTR) {
  }
}

}  // namespace

extern "C" {

int kss_relay_layout(int* head, int* width, int* max_cards) {
  *head = KSS_XHEAD;
  *width = KSS_XW;
  *max_cards = KSS_MAX_CARDS;
  return (int)sizeof(Msg);
}

// Start the relay of the card of mesh index `card` in a row of `cards`
// cards: `inbox` its buffer, and for each of the `npeers` other cards of
// the row its mesh index, the connected socket to its process (the relay
// owns it from here) and its outbox.  Buffers of `slots_total` slots,
// zeroed.  -> the relay, parked; null where its thread cannot start.
void* kss_relay_start(uint64_t* inbox, int card, int cards, int slots_total, int npeers,
                      const int* peer_cards, const int* fds, uint64_t* const* outboxes) {
  Relay* r = new Relay;
  r->inbox = inbox;
  r->card = card;
  r->cards = cards;
  r->col = card % cards;
  r->slots_total = slots_total;
  for (int i = 0; i < npeers; ++i) {
    Peer p;
    p.fd = fds[i];
    p.card = peer_cards[i];
    p.col = peer_cards[i] % cards;
    p.outbox = outboxes[i];
    p.last.assign((size_t)slots_total * 2, 0);
    p.open = true;
    r->peers.push_back(std::move(p));
  }
  if (pipe2(r->wake, O_NONBLOCK | O_CLOEXEC) != 0) {
    delete r;
    return nullptr;
  }
  try {
    r->thread = std::thread(run, r);
  } catch (...) {
    close(r->wake[0]);
    close(r->wake[1]);
    delete r;
    return nullptr;
  }
  return r;
}

// A launch over `slots` pod slots is about to start: spin until parked.
void kss_relay_arm(void* h, int slots) {
  Relay* r = static_cast<Relay*>(h);
  r->slots.store(slots, std::memory_order_release);
  r->armed.fetch_add(1, std::memory_order_acq_rel);
  wake(r);
}

// The launch has ended: sweep once more, then block.
void kss_relay_park(void* h) {
  Relay* r = static_cast<Relay*>(h);
  r->armed.fetch_sub(1, std::memory_order_acq_rel);
  wake(r);
}

// [entries sent, entries received, 1 + the card whose connection was lost
// (0: none), that loss's errno]
void kss_relay_status(void* h, long long* out) {
  const Relay* r = static_cast<const Relay*>(h);
  out[0] = r->sent.load();
  out[1] = r->received.load();
  out[2] = r->lost.load();
  out[3] = r->err.load();
}

// Say goodbye, stop the thread and close the sockets; the buffers are the
// caller's, to free after this.
int kss_relay_stop(void* h) {
  Relay* r = static_cast<Relay*>(h);
  r->stop.store(true, std::memory_order_release);
  wake(r);
  r->thread.join();
  for (Peer& p : r->peers)
    if (p.fd >= 0) close(p.fd);
  close(r->wake[0]);
  close(r->wake[1]);
  delete r;
  return 0;
}

}  // extern "C"
