// Shared-memory SPSC channels: the compiled-graph data plane.
//
// Capability parity with the reference's preallocated mutable-plasma channels
// (reference: python/ray/experimental/channel/shared_memory_channel.py backed
// by src/ray/core_worker/experimental_mutable_object_manager.h), redesigned
// for this framework's serverless shm store: a channel is ONE sealed store
// object whose payload holds [Header | Slot0 | Slot1 | ...]; producer and
// consumer processes both map the segment and synchronize through C++11
// atomics on the header — no RPC, no task submission, no allocation on the
// hot path. Single-producer single-consumer ring (a compiled DAG edge has
// exactly one writer and one reader); capacity doubles as pipeline
// backpressure (reference bounds in-flight executions via channel buffers
// the same way).
//
// The API is zero-copy on both sides: the writer reserves a slot pointer and
// commits with a length; the reader acquires the slot pointer and releases it
// after deserializing. memory_order_release on publish / acquire on consume
// pairs make the payload bytes visible before the sequence number.
//
// Blocking waits ride a FUTEX DOORBELL in the shared header instead of
// sleep-polling (reference: its channels block on OS primitives —
// shared_memory_channel.py reads park in plasma): commit/close ring
// `write_ding`, release rings `read_ding`, and a blocked peer FUTEX_WAITs on
// the ding word. Wakes are issued only when the waiter count is nonzero, so
// the uncontended hot path stays syscall-free. An idle compiled-DAG executor
// parked in rt_chan_wait_readable costs zero CPU.

#include <atomic>
#include <cerrno>
#include <climits>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <new>

#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

constexpr uint64_t kChanMagic = 0x52544348414E0002ULL;  // "RTCHAN" v2 (futex)

struct ChannelHeader {
  uint64_t magic;
  uint64_t nslots;
  uint64_t slot_size;           // payload bytes per slot
  std::atomic<uint64_t> write_seq;  // slots produced
  std::atomic<uint64_t> read_seq;   // slots consumed
  std::atomic<uint64_t> closed;     // writer hung up (reader sees EOF)
  // doorbells (32-bit: futex words must be 4 bytes)
  std::atomic<uint32_t> write_ding;     // bumped on commit/close
  std::atomic<uint32_t> read_ding;      // bumped on release
  std::atomic<uint32_t> read_waiters;   // readers parked on write_ding
  std::atomic<uint32_t> write_waiters;  // writers parked on read_ding
};

int futex_wait(std::atomic<uint32_t>* word, uint32_t expected,
               int64_t timeout_us) {
  struct timespec ts;
  struct timespec* tsp = nullptr;
  if (timeout_us >= 0) {
    ts.tv_sec = timeout_us / 1000000;
    ts.tv_nsec = (timeout_us % 1000000) * 1000;
    tsp = &ts;
  }
  long rc = syscall(SYS_futex, reinterpret_cast<uint32_t*>(word), FUTEX_WAIT,
                    expected, tsp, nullptr, 0);
  if (rc == -1 && errno == ETIMEDOUT) return -1;
  // 0 (woken), EAGAIN (value already changed), EINTR (signal): let the
  // caller re-check the ring — all are "maybe ready"
  return 0;
}

void futex_wake_all(std::atomic<uint32_t>* word) {
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(word), FUTEX_WAKE, INT_MAX,
          nullptr, nullptr, 0);
}

struct Slot {
  uint64_t len;
  // payload follows
};

inline uint64_t slot_stride(uint64_t slot_size) {
  return sizeof(Slot) + ((slot_size + 63) & ~63ULL);  // 64B-align payloads
}

inline Slot* slot_at(ChannelHeader* h, uint64_t idx) {
  auto* base = reinterpret_cast<uint8_t*>(h) + sizeof(ChannelHeader);
  return reinterpret_cast<Slot*>(base +
                                 (idx % h->nslots) * slot_stride(h->slot_size));
}

}  // namespace

extern "C" {

uint64_t rt_chan_required_size(uint64_t nslots, uint64_t slot_size) {
  return sizeof(ChannelHeader) + nslots * slot_stride(slot_size);
}

int rt_chan_init(void* base, uint64_t region_size, uint64_t nslots,
                 uint64_t slot_size) {
  if (region_size < rt_chan_required_size(nslots, slot_size)) return -1;
  auto* h = new (base) ChannelHeader();
  h->magic = kChanMagic;
  h->nslots = nslots;
  h->slot_size = slot_size;
  // tsan: relaxed init stores — rt_chan_init runs before the region's fd/
  // name is handed to the peer, so no second thread can observe them yet.
  h->write_seq.store(0, std::memory_order_relaxed);
  h->read_seq.store(0, std::memory_order_relaxed);
  h->closed.store(0, std::memory_order_relaxed);
  h->write_ding.store(0, std::memory_order_relaxed);
  h->read_ding.store(0, std::memory_order_relaxed);
  h->read_waiters.store(0, std::memory_order_relaxed);
  h->write_waiters.store(0, std::memory_order_relaxed);
  return 0;
}

int rt_chan_validate(void* base) {
  auto* h = reinterpret_cast<ChannelHeader*>(base);
  return h->magic == kChanMagic ? 0 : -1;
}

// Writer side. rt_chan_reserve returns the offset (from base) of the slot
// payload to write into, -1 if the ring is full (backpressure), or -3 if
// the ring is closed (either end hung up — writes must fail fast, e.g. a
// teardown-racing rpc_chan_write against a reader that already closed).
int64_t rt_chan_reserve(void* base) {
  auto* h = reinterpret_cast<ChannelHeader*>(base);
  if (h->closed.load(std::memory_order_acquire)) return -3;
  // tsan: relaxed — SPSC: write_seq is only ever stored by this (the single
  // writer) thread, so reading our own last store needs no ordering.
  uint64_t w = h->write_seq.load(std::memory_order_relaxed);
  // acquire pairs with rt_chan_release's read_seq.store(release): seeing
  // r proves the reader is done with slots below r, so reuse is safe.
  uint64_t r = h->read_seq.load(std::memory_order_acquire);
  if (w - r >= h->nslots) return -1;  // full
  auto* s = slot_at(h, w);
  return reinterpret_cast<uint8_t*>(s) + sizeof(Slot) -
         reinterpret_cast<uint8_t*>(base);
}

int rt_chan_commit(void* base, uint64_t len) {
  auto* h = reinterpret_cast<ChannelHeader*>(base);
  if (len > h->slot_size) return -2;
  // tsan: relaxed — writer-owned counter (see rt_chan_reserve).
  uint64_t w = h->write_seq.load(std::memory_order_relaxed);
  slot_at(h, w)->len = len;
  // release publishes the payload + len to the reader's acquire load.
  h->write_seq.store(w + 1, std::memory_order_release);
  h->write_ding.fetch_add(1, std::memory_order_release);
  if (h->read_waiters.load(std::memory_order_acquire) != 0)
    futex_wake_all(&h->write_ding);
  return 0;
}

// Reader side. rt_chan_acquire returns the payload offset and length of the
// next unread slot, or -1 if empty, -2 if empty AND closed (EOF).
int64_t rt_chan_acquire(void* base, uint64_t* out_len) {
  auto* h = reinterpret_cast<ChannelHeader*>(base);
  // tsan: relaxed — SPSC: read_seq is only ever stored by this (the single
  // reader) thread, so reading our own last store needs no ordering.
  uint64_t r = h->read_seq.load(std::memory_order_relaxed);
  // acquire pairs with rt_chan_commit's write_seq.store(release) and makes
  // the slot payload + len visible before we touch them.
  uint64_t w = h->write_seq.load(std::memory_order_acquire);
  if (r == w) {
    return h->closed.load(std::memory_order_acquire) ? -2 : -1;
  }
  auto* s = slot_at(h, r);
  *out_len = s->len;
  return reinterpret_cast<uint8_t*>(s) + sizeof(Slot) -
         reinterpret_cast<uint8_t*>(base);
}

int rt_chan_release(void* base) {
  auto* h = reinterpret_cast<ChannelHeader*>(base);
  // tsan: relaxed — reader-owned counter (see rt_chan_acquire).
  uint64_t r = h->read_seq.load(std::memory_order_relaxed);
  // release returns the slot to the writer: pairs with rt_chan_reserve's
  // acquire load and orders our payload reads before slot reuse.
  h->read_seq.store(r + 1, std::memory_order_release);
  h->read_ding.fetch_add(1, std::memory_order_release);
  if (h->write_waiters.load(std::memory_order_acquire) != 0)
    futex_wake_all(&h->read_ding);
  return 0;
}

void rt_chan_close(void* base) {
  auto* h = reinterpret_cast<ChannelHeader*>(base);
  h->closed.store(1, std::memory_order_release);
  // close must reach parked readers even with no payload in flight, AND
  // parked writers (a reader closing a full ring at teardown must fail
  // blocked producers fast, not strand them until timeout)
  h->write_ding.fetch_add(1, std::memory_order_release);
  futex_wake_all(&h->write_ding);
  h->read_ding.fetch_add(1, std::memory_order_release);
  futex_wake_all(&h->read_ding);
}

// Park until the ring is (probably) readable: data available or closed.
// Returns 0 = re-check now (data/closed/spurious wake), -1 = timed out.
// timeout_us < 0 waits indefinitely. Callers always loop over
// try-acquire, so a spurious 0 is harmless.
int rt_chan_wait_readable(void* base, int64_t timeout_us) {
  auto* h = reinterpret_cast<ChannelHeader*>(base);
  uint32_t ding = h->write_ding.load(std::memory_order_acquire);
  // tsan: relaxed — reader-owned counter; only the reader parks here.
  uint64_t r = h->read_seq.load(std::memory_order_relaxed);
  if (h->write_seq.load(std::memory_order_acquire) != r ||
      h->closed.load(std::memory_order_acquire))
    return 0;
  h->read_waiters.fetch_add(1, std::memory_order_acq_rel);
  // A commit between the ding load and the kernel's futex compare bumps
  // write_ding, so FUTEX_WAIT returns EAGAIN instead of sleeping — no
  // lost-wakeup window.
  int rc = futex_wait(&h->write_ding, ding, timeout_us);
  h->read_waiters.fetch_sub(1, std::memory_order_acq_rel);
  return rc;
}

// Park until the ring has (probably) a free slot. Same contract as
// rt_chan_wait_readable.
int rt_chan_wait_writable(void* base, int64_t timeout_us) {
  auto* h = reinterpret_cast<ChannelHeader*>(base);
  uint32_t ding = h->read_ding.load(std::memory_order_acquire);
  if (h->closed.load(std::memory_order_acquire)) return 0;  // fail fast
  // tsan: relaxed — writer-owned counter; only the writer parks here.
  uint64_t w = h->write_seq.load(std::memory_order_relaxed);
  if (w - h->read_seq.load(std::memory_order_acquire) < h->nslots) return 0;
  h->write_waiters.fetch_add(1, std::memory_order_acq_rel);
  int rc = futex_wait(&h->read_ding, ding, timeout_us);
  h->write_waiters.fetch_sub(1, std::memory_order_acq_rel);
  return rc;
}

uint64_t rt_chan_readable(void* base) {
  auto* h = reinterpret_cast<ChannelHeader*>(base);
  return h->write_seq.load(std::memory_order_acquire) -
         h->read_seq.load(std::memory_order_acquire);
}

uint64_t rt_chan_slot_size(void* base) {
  return reinterpret_cast<ChannelHeader*>(base)->slot_size;
}

// Touch every payload page of every slot in THIS process's mapping so the
// first real transfer doesn't eat a minor fault per 4KB (shmem THP is
// commonly disabled). write=1 does a read-modify-write (installs writable
// PTEs for the producer side); only safe while the ring carries no
// committed slots.
void rt_chan_prefault(void* base, int write) {
  auto* h = reinterpret_cast<ChannelHeader*>(base);
  for (uint64_t i = 0; i < h->nslots; i++) {
    auto* p = reinterpret_cast<volatile uint8_t*>(slot_at(h, i)) +
              sizeof(Slot);
    for (uint64_t off = 0; off < h->slot_size; off += 4096) {
      if (write) {
        p[off] = p[off];
      } else {
        (void)p[off];
      }
    }
  }
}

}  // extern "C"
