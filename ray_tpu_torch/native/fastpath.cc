// Native control-plane fast path: the C++ submission/completion engine.
//
// Capability parity with the reference's compiled submission seam
// (reference: python/ray/_raylet.pyx:3817 submit_task — every .remote()
// crosses into C++ there, which is how the reference sustains a 1M+-queued
// single-node envelope). This framework's pure-Python submit path tops out
// two orders of magnitude lower; this engine owns the three hot inner loops:
//
//   (a) SPEC ENCODING — a TaskSpec-shaped dict is serialized into the wire
//       msgpack format in C++. Repeated byte strings (map keys, function
//       descriptors, owner addresses, resource/strategy sub-maps) are
//       interned ONCE as pre-encoded msgpack fragments: a registered
//       "template" is the full wire map split around its two per-task
//       fields (task_id, args), so encoding one spec is three memcpys plus
//       two headers instead of a 25-key dict walk in the interpreter.
//   (b) SUBMISSION RING — encoded specs enter a lock-free bounded MPMC ring
//       (Vyukov sequence-number scheme) straight from the caller thread;
//       no event-loop hop, no allocation beyond the entry itself. Feeder
//       coroutines pop in batches.
//   (c) BATCHED FRAMES — a popped batch is assembled into ONE complete
//       length-prefixed RPC frame ([_REQ, req_id, "push_task_batch",
//       {"specs": [...]}]) in a single buffer handed to the asyncio sender
//       as one write. On the completion side, a stream SPLITTER carves the
//       raw TCP bytes into frames and pre-parses each header (kind,
//       req_id, method) so Python resolves a whole chunk of futures per
//       read() instead of one coroutine iteration per reply.
//
// Loaded via ctypes (see _private/fastpath.py) like the sibling shm_store /
// shm_channel libraries; when the toolchain is missing the Python path runs
// unchanged (config flag `native_fastpath`).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <mutex>

namespace {

constexpr int32_t kMaxRings = 256;
constexpr int32_t kMaxTemplates = 4096;
constexpr uint32_t kMaxTidLen = 32;
constexpr uint64_t kMaxFrame = 512ULL * 1024 * 1024;  // matches rpc.MAX_FRAME

// ---------------------------------------------------------------------------
// msgpack emit helpers (writer side only needs a tiny subset)
// ---------------------------------------------------------------------------

inline uint64_t uint_size(uint64_t v) {
  if (v < 0x80) return 1;
  if (v <= 0xff) return 2;
  if (v <= 0xffff) return 3;
  if (v <= 0xffffffffULL) return 5;
  return 9;
}

inline uint8_t* emit_uint(uint8_t* p, uint64_t v) {
  if (v < 0x80) {
    *p++ = static_cast<uint8_t>(v);
  } else if (v <= 0xff) {
    *p++ = 0xcc;
    *p++ = static_cast<uint8_t>(v);
  } else if (v <= 0xffff) {
    *p++ = 0xcd;
    *p++ = static_cast<uint8_t>(v >> 8);
    *p++ = static_cast<uint8_t>(v);
  } else if (v <= 0xffffffffULL) {
    *p++ = 0xce;
    for (int s = 24; s >= 0; s -= 8) *p++ = static_cast<uint8_t>(v >> s);
  } else {
    *p++ = 0xcf;
    for (int s = 56; s >= 0; s -= 8) *p++ = static_cast<uint8_t>(v >> s);
  }
  return p;
}

inline uint64_t array_hdr_size(uint32_t n) {
  if (n < 16) return 1;
  if (n <= 0xffff) return 3;
  return 5;
}

inline uint8_t* emit_array_hdr(uint8_t* p, uint32_t n) {
  if (n < 16) {
    *p++ = 0x90 | static_cast<uint8_t>(n);
  } else if (n <= 0xffff) {
    *p++ = 0xdc;
    *p++ = static_cast<uint8_t>(n >> 8);
    *p++ = static_cast<uint8_t>(n);
  } else {
    *p++ = 0xdd;
    for (int s = 24; s >= 0; s -= 8) *p++ = static_cast<uint8_t>(n >> s);
  }
  return p;
}

// bin8 header (task ids are <= 32 bytes)
inline uint8_t* emit_bin8(uint8_t* p, const uint8_t* data, uint32_t len) {
  *p++ = 0xc4;
  *p++ = static_cast<uint8_t>(len);
  memcpy(p, data, len);
  return p + len;
}

// ---------------------------------------------------------------------------
// entries and the Vyukov bounded MPMC ring
// ---------------------------------------------------------------------------

inline uint64_t mono_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ULL +
         static_cast<uint64_t>(ts.tv_nsec);
}

struct FpEntry {
  uint32_t tid_len;
  uint8_t tid[kMaxTidLen];
  uint64_t len;     // encoded spec bytes
  uint64_t enq_ns;  // CLOCK_MONOTONIC stamp at ring enqueue (the per-hop
                    // telemetry's ring_wait hop; ~20ns per encode, cheap
                    // enough to stamp unconditionally)
  // spec bytes follow inline
  uint8_t* data() { return reinterpret_cast<uint8_t*>(this + 1); }
};

struct Cell {
  std::atomic<uint64_t> seq;
  FpEntry* ent;
};

struct Ring {
  Cell* cells;
  uint64_t mask;
  alignas(64) std::atomic<uint64_t> enqueue_pos;
  alignas(64) std::atomic<uint64_t> dequeue_pos;

  explicit Ring(uint64_t slots) {
    // round up to a power of two
    uint64_t cap = 1;
    while (cap < slots) cap <<= 1;
    cells = static_cast<Cell*>(calloc(cap, sizeof(Cell)));
    mask = cap - 1;
    // tsan: relaxed init stores — single-threaded constructor; the Ring is
    // published to other threads only via nrings.store(release) in
    // rt_fp_ring_create, which orders all of these before any reader.
    for (uint64_t i = 0; i < cap; i++)
      cells[i].seq.store(i, std::memory_order_relaxed);
    enqueue_pos.store(0, std::memory_order_relaxed);
    dequeue_pos.store(0, std::memory_order_relaxed);
  }
  ~Ring() { free(cells); }

  // Vyukov bounded MPMC: the cell's `seq` is the only synchronization edge
  // for the payload. Positions are mere tickets — a stale read just retries.
  bool push(FpEntry* e) {
    Cell* cell;
    // tsan: relaxed — enqueue_pos is a ticket counter, not a publication
    // point; a stale value fails the seq check below and reloads.
    uint64_t pos = enqueue_pos.load(std::memory_order_relaxed);
    for (;;) {
      cell = &cells[pos & mask];
      // acquire pairs with the consumer's seq.store(release) in pop():
      // seeing seq==pos proves the previous occupant's payload read is done.
      uint64_t seq = cell->seq.load(std::memory_order_acquire);
      intptr_t dif = static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos);
      if (dif == 0) {
        // tsan: relaxed CAS — winning only claims the ticket; the payload
        // publication below rides cell->seq.store(release), not this CAS.
        if (enqueue_pos.compare_exchange_weak(pos, pos + 1,
                                              std::memory_order_relaxed))
          break;
      } else if (dif < 0) {
        return false;  // full
      } else {
        // tsan: relaxed — refresh the ticket after losing a race; validated
        // by the next acquire load of cell->seq.
        pos = enqueue_pos.load(std::memory_order_relaxed);
      }
    }
    cell->ent = e;
    // release publishes cell->ent to the consumer's acquire load of seq.
    cell->seq.store(pos + 1, std::memory_order_release);
    return true;
  }

  FpEntry* pop() {
    Cell* cell;
    // tsan: relaxed — dequeue_pos is a ticket counter (see push()).
    uint64_t pos = dequeue_pos.load(std::memory_order_relaxed);
    for (;;) {
      cell = &cells[pos & mask];
      // acquire pairs with the producer's seq.store(pos+1, release): seeing
      // seq==pos+1 makes the cell->ent write below visible to this thread.
      uint64_t seq = cell->seq.load(std::memory_order_acquire);
      intptr_t dif =
          static_cast<intptr_t>(seq) - static_cast<intptr_t>(pos + 1);
      if (dif == 0) {
        // tsan: relaxed CAS — claims the ticket only; the payload was
        // already acquired via cell->seq above.
        if (dequeue_pos.compare_exchange_weak(pos, pos + 1,
                                              std::memory_order_relaxed))
          break;
      } else if (dif < 0) {
        return nullptr;  // empty
      } else {
        // tsan: relaxed — ticket refresh after a lost race (see push()).
        pos = dequeue_pos.load(std::memory_order_relaxed);
      }
    }
    FpEntry* e = cell->ent;
    // release hands the cell back to a producer one lap ahead: pairs with
    // push()'s acquire load and orders our cell->ent read before reuse.
    cell->seq.store(pos + mask + 1, std::memory_order_release);
    return e;
  }

  uint64_t approx_len() {
    uint64_t e = enqueue_pos.load(std::memory_order_acquire);
    uint64_t d = dequeue_pos.load(std::memory_order_acquire);
    return e > d ? e - d : 0;
  }
};

// a template is the wire spec map split around (task_id, args)
struct Template {
  uint8_t *pre, *mid, *suf;
  uint64_t pre_len, mid_len, suf_len;
};

struct Engine {
  std::mutex reg_mu;  // ring/template registration only (cold path)
  Ring* rings[kMaxRings];
  Template templates[kMaxTemplates];
  std::atomic<int32_t> nrings{0};
  std::atomic<int32_t> ntemplates{0};
  uint64_t ring_slots;
};

uint8_t* dup_bytes(const uint8_t* p, uint64_t n) {
  uint8_t* out = static_cast<uint8_t*>(malloc(n ? n : 1));
  if (out && n) memcpy(out, p, n);
  return out;
}

}  // namespace

extern "C" {

int32_t rt_fp_abi_version() { return 2; }

void* rt_fp_engine_create(uint64_t ring_slots) {
  Engine* e = new Engine();
  e->ring_slots = ring_slots ? ring_slots : 65536;
  return e;
}

void rt_fp_engine_destroy(void* h) {
  Engine* e = static_cast<Engine*>(h);
  int32_t nr = e->nrings.load(std::memory_order_acquire);
  for (int32_t i = 0; i < nr; i++) {
    for (FpEntry* ent = e->rings[i]->pop(); ent; ent = e->rings[i]->pop())
      free(ent);
    delete e->rings[i];
  }
  int32_t nt = e->ntemplates.load(std::memory_order_acquire);
  for (int32_t i = 0; i < nt; i++) {
    free(e->templates[i].pre);
    free(e->templates[i].mid);
    free(e->templates[i].suf);
  }
  delete e;
}

int32_t rt_fp_ring_create(void* h) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->reg_mu);
  // tsan: relaxed — only registrars mutate nrings and they serialize on
  // reg_mu; concurrent readers use the acquire load at the call sites.
  int32_t id = e->nrings.load(std::memory_order_relaxed);
  if (id >= kMaxRings) return -1;
  e->rings[id] = new Ring(e->ring_slots);
  // release publishes rings[id] (and the Ring's relaxed init) to readers'
  // acquire loads of nrings.
  e->nrings.store(id + 1, std::memory_order_release);
  return id;
}

int32_t rt_fp_template_register(void* h, const uint8_t* pre, uint64_t pre_len,
                                const uint8_t* mid, uint64_t mid_len,
                                const uint8_t* suf, uint64_t suf_len) {
  Engine* e = static_cast<Engine*>(h);
  std::lock_guard<std::mutex> g(e->reg_mu);
  // tsan: relaxed — writers serialize on reg_mu (see rt_fp_ring_create).
  int32_t id = e->ntemplates.load(std::memory_order_relaxed);
  if (id >= kMaxTemplates) return -1;
  Template& t = e->templates[id];
  t.pre = dup_bytes(pre, pre_len);
  t.mid = dup_bytes(mid, mid_len);
  t.suf = dup_bytes(suf, suf_len);
  t.pre_len = pre_len;
  t.mid_len = mid_len;
  t.suf_len = suf_len;
  e->ntemplates.store(id + 1, std::memory_order_release);
  return id;
}

// Encode one spec from a template + the two per-task fields and push it onto
// `ring`. `args` is a complete pre-encoded msgpack value (the wire args
// list). Returns 0, -1 if the ring is full, -2 on a bad id.
int32_t rt_fp_encode(void* h, int32_t ring, int32_t tmpl, const uint8_t* tid,
                     uint32_t tid_len, const uint8_t* args,
                     uint64_t args_len) {
  Engine* e = static_cast<Engine*>(h);
  if (ring < 0 || ring >= e->nrings.load(std::memory_order_acquire) ||
      tmpl < 0 || tmpl >= e->ntemplates.load(std::memory_order_acquire) ||
      tid_len > kMaxTidLen)
    return -2;
  const Template& t = e->templates[tmpl];
  uint64_t spec_len =
      t.pre_len + 2 + tid_len + t.mid_len + args_len + t.suf_len;
  FpEntry* ent =
      static_cast<FpEntry*>(malloc(sizeof(FpEntry) + spec_len));
  if (!ent) return -1;
  ent->tid_len = tid_len;
  memcpy(ent->tid, tid, tid_len);
  ent->len = spec_len;
  ent->enq_ns = mono_ns();
  uint8_t* p = ent->data();
  memcpy(p, t.pre, t.pre_len);
  p += t.pre_len;
  p = emit_bin8(p, tid, tid_len);
  memcpy(p, t.mid, t.mid_len);
  p += t.mid_len;
  memcpy(p, args, args_len);
  p += args_len;
  memcpy(p, t.suf, t.suf_len);
  if (!e->rings[ring]->push(ent)) {
    free(ent);
    return -1;
  }
  return 0;
}

// Push an already fully-encoded wire spec (the fallback for shapes with no
// registered template, and for retries re-entering the ring).
int32_t rt_fp_encode_raw(void* h, int32_t ring, const uint8_t* tid,
                         uint32_t tid_len, const uint8_t* spec,
                         uint64_t spec_len) {
  Engine* e = static_cast<Engine*>(h);
  if (ring < 0 || ring >= e->nrings.load(std::memory_order_acquire) ||
      tid_len > kMaxTidLen)
    return -2;
  FpEntry* ent =
      static_cast<FpEntry*>(malloc(sizeof(FpEntry) + spec_len));
  if (!ent) return -1;
  ent->tid_len = tid_len;
  memcpy(ent->tid, tid, tid_len);
  ent->len = spec_len;
  ent->enq_ns = mono_ns();
  memcpy(ent->data(), spec, spec_len);
  if (!e->rings[ring]->push(ent)) {
    free(ent);
    return -1;
  }
  return 0;
}

uint64_t rt_fp_ring_len(void* h, int32_t ring) {
  Engine* e = static_cast<Engine*>(h);
  if (ring < 0 || ring >= e->nrings.load(std::memory_order_acquire)) return 0;
  return e->rings[ring]->approx_len();
}

// Pop up to `max_n` entries. Fills `out_handles` (opaque entry pointers the
// caller now owns), `out_tids` (max_n slots of [1-byte len][kMaxTidLen
// bytes]) and `out_wait_ns` (per-entry ring residency: now − enqueue stamp —
// the ring_wait hop of the latency decomposition). Returns the number
// popped.
int32_t rt_fp_pop(void* h, int32_t ring, int32_t max_n, uint64_t* out_handles,
                  uint8_t* out_tids, uint64_t* out_wait_ns) {
  Engine* e = static_cast<Engine*>(h);
  if (ring < 0 || ring >= e->nrings.load(std::memory_order_acquire)) return 0;
  Ring* r = e->rings[ring];
  int32_t n = 0;
  uint64_t now = mono_ns();
  while (n < max_n) {
    FpEntry* ent = r->pop();
    if (!ent) break;
    out_handles[n] = reinterpret_cast<uint64_t>(ent);
    uint8_t* slot = out_tids + n * (1 + kMaxTidLen);
    slot[0] = static_cast<uint8_t>(ent->tid_len);
    memcpy(slot + 1, ent->tid, ent->tid_len);
    out_wait_ns[n] = now > ent->enq_ns ? now - ent->enq_ns : 0;
    n++;
  }
  return n;
}

void rt_fp_entry_free(uint64_t handle) {
  free(reinterpret_cast<FpEntry*>(handle));
}

// Total bytes of the complete frame rt_fp_batch_build would produce.
uint64_t rt_fp_batch_frame_size(const uint64_t* handles, int32_t n,
                                uint64_t req_id, const uint8_t* method,
                                uint32_t method_len) {
  uint64_t body = 1                  // fixarray(4)
                  + 1                // kind (_REQ = 0, positive fixint)
                  + uint_size(req_id)
                  + 1 + method_len   // fixstr header + bytes (len < 32)
                  + 1                // fixmap(1)
                  + 6                // fixstr "specs"
                  + array_hdr_size(static_cast<uint32_t>(n));
  for (int32_t i = 0; i < n; i++)
    body += reinterpret_cast<FpEntry*>(handles[i])->len;
  return 4 + body;  // u32 little-endian length prefix
}

// Build one complete RPC frame: [u32 len][msgpack [0, req_id, method,
// {"specs": [spec...]}]]. Frees every entry. Returns bytes written, or -1
// if `cap` is too small / the frame would exceed the transport limit (the
// entries are NOT freed in that case).
int64_t rt_fp_batch_build(const uint64_t* handles, int32_t n, uint64_t req_id,
                          const uint8_t* method, uint32_t method_len,
                          uint8_t* out, uint64_t cap) {
  if (method_len >= 32) return -1;
  uint64_t total = rt_fp_batch_frame_size(handles, n, req_id, method,
                                          method_len);
  if (total > cap || total - 4 > kMaxFrame) return -1;
  uint8_t* p = out;
  uint64_t body = total - 4;
  *p++ = static_cast<uint8_t>(body);
  *p++ = static_cast<uint8_t>(body >> 8);
  *p++ = static_cast<uint8_t>(body >> 16);
  *p++ = static_cast<uint8_t>(body >> 24);
  *p++ = 0x94;  // [kind, req_id, method, payload]
  *p++ = 0x00;  // _REQ
  p = emit_uint(p, req_id);
  *p++ = 0xa0 | static_cast<uint8_t>(method_len);
  memcpy(p, method, method_len);
  p += method_len;
  *p++ = 0x81;  // {"specs": [...]}
  *p++ = 0xa5;
  memcpy(p, "specs", 5);
  p += 5;
  p = emit_array_hdr(p, static_cast<uint32_t>(n));
  for (int32_t i = 0; i < n; i++) {
    FpEntry* ent = reinterpret_cast<FpEntry*>(handles[i]);
    memcpy(p, ent->data(), ent->len);
    p += ent->len;
    free(ent);
  }
  return static_cast<int64_t>(p - out);
}

// ---------------------------------------------------------------------------
// completion-side stream splitter
// ---------------------------------------------------------------------------

namespace {

struct Splitter {
  uint8_t* buf = nullptr;
  uint64_t cap = 0;
  uint64_t len = 0;  // valid bytes
  uint64_t rd = 0;   // consumed bytes
};

// minimal msgpack reads for the frame header [kind:int, req_id:int,
// method:str, payload:any]
bool parse_uint_at(const uint8_t* p, const uint8_t* end, uint64_t* val,
                   const uint8_t** next) {
  if (p >= end) return false;
  uint8_t b = *p++;
  if (b < 0x80) {
    *val = b;
  } else if (b == 0xcc) {
    if (p + 1 > end) return false;
    *val = *p++;
  } else if (b == 0xcd) {
    if (p + 2 > end) return false;
    *val = (static_cast<uint64_t>(p[0]) << 8) | p[1];
    p += 2;
  } else if (b == 0xce) {
    if (p + 4 > end) return false;
    *val = 0;
    for (int i = 0; i < 4; i++) *val = (*val << 8) | p[i];
    p += 4;
  } else if (b == 0xcf) {
    if (p + 8 > end) return false;
    *val = 0;
    for (int i = 0; i < 8; i++) *val = (*val << 8) | p[i];
    p += 8;
  } else {
    return false;
  }
  *next = p;
  return true;
}

bool parse_array_hdr_at(const uint8_t* p, const uint8_t* end, uint32_t* n,
                        const uint8_t** next) {
  if (p >= end) return false;
  uint8_t b = *p++;
  if ((b & 0xf0) == 0x90) {
    *n = b & 0x0f;
  } else if (b == 0xdc) {
    if (p + 2 > end) return false;
    *n = (static_cast<uint32_t>(p[0]) << 8) | p[1];
    p += 2;
  } else if (b == 0xdd) {
    if (p + 4 > end) return false;
    *n = 0;
    for (int i = 0; i < 4; i++) *n = (*n << 8) | p[i];
    p += 4;
  } else {
    return false;
  }
  *next = p;
  return true;
}

bool parse_str_at(const uint8_t* p, const uint8_t* end, uint64_t* off,
                  uint32_t* slen, const uint8_t* base, const uint8_t** next) {
  if (p >= end) return false;
  uint8_t b = *p++;
  uint32_t n;
  if ((b & 0xe0) == 0xa0) {
    n = b & 0x1f;
  } else if (b == 0xd9) {
    if (p + 1 > end) return false;
    n = *p++;
  } else if (b == 0xda) {
    if (p + 2 > end) return false;
    n = (static_cast<uint32_t>(p[0]) << 8) | p[1];
    p += 2;
  } else {
    return false;
  }
  if (p + n > end) return false;
  *off = static_cast<uint64_t>(p - base);
  *slen = n;
  *next = p + n;
  return true;
}

}  // namespace

void* rt_fp_splitter_create() { return new Splitter(); }

void rt_fp_splitter_destroy(void* h) {
  Splitter* s = static_cast<Splitter*>(h);
  free(s->buf);
  delete s;
}

// Append raw stream bytes. Returns 0 on success, -1 on allocation failure.
int32_t rt_fp_splitter_feed(void* h, const uint8_t* data, uint64_t n) {
  Splitter* s = static_cast<Splitter*>(h);
  // compact consumed prefix when it dominates the buffer
  if (s->rd == s->len) {
    s->rd = 0;
    s->len = 0;
  } else if (s->rd > (1 << 20) && s->rd > s->len / 2) {
    memmove(s->buf, s->buf + s->rd, s->len - s->rd);
    s->len -= s->rd;
    s->rd = 0;
  }
  if (s->len + n > s->cap) {
    uint64_t want = s->cap ? s->cap : 65536;
    while (want < s->len + n) want <<= 1;
    uint8_t* nb = static_cast<uint8_t*>(realloc(s->buf, want));
    if (!nb) return -1;
    s->buf = nb;
    s->cap = want;
  }
  memcpy(s->buf + s->len, data, n);
  s->len += n;
  return 0;
}

const uint8_t* rt_fp_splitter_base(void* h) {
  return static_cast<Splitter*>(h)->buf;
}

// Carve the next complete frame. Returns:
//   1  — a frame was produced; *frame_off/*frame_len cover the msgpack body
//        (length prefix stripped); if the header parsed, *kind/*req_id and
//        the method/payload spans are filled, else *kind = 0xffffffff and
//        the caller must unpack the whole body.
//   0  — need more bytes.
//  -1  — oversized frame (protocol violation; caller should drop the
//        connection, matching MAX_FRAME on the Python side).
// Offsets are relative to rt_fp_splitter_base() and remain valid until the
// next feed() call.
int32_t rt_fp_splitter_next(void* h, uint64_t* frame_off, uint64_t* frame_len,
                            uint32_t* kind, uint64_t* req_id,
                            uint64_t* method_off, uint32_t* method_len,
                            uint64_t* payload_off, uint64_t* payload_len) {
  Splitter* s = static_cast<Splitter*>(h);
  if (s->len - s->rd < 4) return 0;
  const uint8_t* p = s->buf + s->rd;
  uint64_t body = static_cast<uint64_t>(p[0]) |
                  (static_cast<uint64_t>(p[1]) << 8) |
                  (static_cast<uint64_t>(p[2]) << 16) |
                  (static_cast<uint64_t>(p[3]) << 24);
  if (body > kMaxFrame) return -1;
  if (s->len - s->rd - 4 < body) return 0;
  const uint8_t* start = p + 4;
  const uint8_t* end = start + body;
  *frame_off = static_cast<uint64_t>(start - s->buf);
  *frame_len = body;
  s->rd += 4 + body;

  // best-effort header pre-parse; any surprise defers to Python's unpacker
  *kind = 0xffffffffu;
  uint32_t nelem;
  const uint8_t* q = start;
  uint64_t k, rid;
  uint32_t mlen;
  uint64_t moff;
  if (!parse_array_hdr_at(q, end, &nelem, &q) || nelem != 4) return 1;
  if (!parse_uint_at(q, end, &k, &q)) return 1;
  if (!parse_uint_at(q, end, &rid, &q)) return 1;
  if (!parse_str_at(q, end, &moff, &mlen, s->buf, &q)) return 1;
  *kind = static_cast<uint32_t>(k);
  *req_id = rid;
  *method_off = moff;
  *method_len = mlen;
  *payload_off = static_cast<uint64_t>(q - s->buf);
  *payload_len = static_cast<uint64_t>(end - q);
  return 1;
}

}  // extern "C"
