// Shared-memory object store: the node-local zero-copy object plane.
//
// Capability parity with the reference's plasma store
// (reference: src/ray/object_manager/plasma/store.h:55, object_store.h:76,
// object_lifecycle_manager.h, eviction_policy.h, plasma_allocator.h, dlmalloc.cc),
// redesigned without a store server process: instead of a socket protocol with
// fd-passing (reference: plasma/fling.cc), every process on the node maps the same
// named POSIX shm segment which contains the allocator heap, the object table, and
// a robust process-shared mutex. create/seal/get/release are direct shm operations
// (~sub-microsecond), reads are zero-copy mmap views, and crash recovery relies on
// robust-mutex EOWNERDEAD plus per-process reference reconciliation done by the
// node daemon.
//
// Layout:
//   [StoreHeader | ObjectEntry[capacity] | heap ...]
//
// Heap: first-fit free list with coalescing (simplified dlmalloc-style, reference
// vendors dlmalloc at src/ray/thirdparty/dlmalloc.c). Eviction: LRU over sealed,
// unreferenced objects (reference: plasma/eviction_policy.h).

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x52415954505553ULL;  // "RAYTPUS"
constexpr int kIdSize = 24;
constexpr uint32_t kEntryFree = 0;
constexpr uint32_t kEntryCreated = 1;
constexpr uint32_t kEntrySealed = 2;

struct ObjectEntry {
  uint8_t id[kIdSize];
  uint32_t state;
  int32_t refcount;
  uint64_t data_size;
  uint64_t offset;  // from segment base
  uint64_t lru_tick;
  uint64_t metadata;  // small user tag (e.g. error bit)
};

struct FreeBlock {
  uint64_t size;      // includes this header
  uint64_t next_off;  // offset of next free block, 0 = end
};

struct StoreHeader {
  uint64_t magic;
  uint64_t total_size;
  uint64_t heap_offset;
  uint64_t heap_size;
  uint64_t capacity;      // object table slots
  uint64_t free_head;     // offset of first free block (0 = none)
  uint64_t lru_clock;
  uint64_t bytes_in_use;
  uint64_t num_objects;
  pthread_mutex_t lock;
  // tsan: seal_seq is the store's only atomic — every other header field is
  // written exclusively under the robust `lock` (Guard). It stays seq_cst
  // (defaulted orders) so a poller may read it WITHOUT the lock and still
  // see a monotone value; today's callers happen to hold the Guard anyway.
  std::atomic<uint64_t> seal_seq;  // bumped on every seal, for pollers
};

struct Store {
  StoreHeader* hdr;
  ObjectEntry* table;
  uint8_t* base;
  uint64_t map_size;
  int fd;
};

inline uint64_t align8(uint64_t v) { return (v + 7) & ~7ULL; }

class Guard {
 public:
  explicit Guard(StoreHeader* h) : h_(h) {
    int rc = pthread_mutex_lock(&h->lock);
    if (rc == EOWNERDEAD) {
      // A process died holding the lock; state is still structurally valid
      // because all mutations are ordered to be crash-consistent enough for
      // the daemon to reconcile. Mark consistent and continue.
      pthread_mutex_consistent(&h->lock);
    }
  }
  ~Guard() { pthread_mutex_unlock(&h_->lock); }

 private:
  StoreHeader* h_;
};

uint64_t hash_id(const uint8_t* id) {
  uint64_t h = 1469598103934665603ULL;
  for (int i = 0; i < kIdSize; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

// Open-addressed lookup. Returns entry with matching id, or (if insert) the
// first free slot on the probe path, or nullptr.
ObjectEntry* find_entry(Store* s, const uint8_t* id, bool insert) {
  uint64_t cap = s->hdr->capacity;
  uint64_t idx = hash_id(id) % cap;
  ObjectEntry* first_free = nullptr;
  for (uint64_t probe = 0; probe < cap; probe++) {
    ObjectEntry* e = &s->table[(idx + probe) % cap];
    if (e->state == kEntryFree) {
      if (first_free == nullptr) first_free = e;
      // Free slot ends the probe chain only if never-used; we use simple
      // convention: stop at free slot (no tombstones: deletes compact by
      // re-inserting the rest of the cluster).
      break;
    }
    if (memcmp(e->id, id, kIdSize) == 0) return e;
  }
  return insert ? first_free : nullptr;
}

// Robin-hood style cluster fix after deletion to keep probing correct.
void rehash_cluster(Store* s, uint64_t hole_idx) {
  uint64_t cap = s->hdr->capacity;
  uint64_t idx = (hole_idx + 1) % cap;
  while (s->table[idx].state != kEntryFree) {
    ObjectEntry copy = s->table[idx];
    s->table[idx].state = kEntryFree;
    ObjectEntry* slot = find_entry(s, copy.id, true);
    *slot = copy;
    idx = (idx + 1) % cap;
  }
}

uint64_t heap_alloc(Store* s, uint64_t want) {
  want = align8(want);
  if (want < sizeof(FreeBlock)) want = sizeof(FreeBlock);
  uint64_t prev_off = 0;
  uint64_t off = s->hdr->free_head;
  while (off) {
    FreeBlock* b = reinterpret_cast<FreeBlock*>(s->base + off);
    if (b->size >= want + sizeof(uint64_t)) {
      uint64_t remain = b->size - want - sizeof(uint64_t);
      uint64_t data_off;
      if (remain >= sizeof(FreeBlock) + sizeof(uint64_t)) {
        // split: allocate from the tail of the block
        b->size -= (want + sizeof(uint64_t));
        uint64_t alloc_off = off + b->size;
        *reinterpret_cast<uint64_t*>(s->base + alloc_off) = want + sizeof(uint64_t);
        data_off = alloc_off + sizeof(uint64_t);
      } else {
        // take whole block
        uint64_t next = b->next_off;
        uint64_t bsize = b->size;
        if (prev_off) {
          reinterpret_cast<FreeBlock*>(s->base + prev_off)->next_off = next;
        } else {
          s->hdr->free_head = next;
        }
        *reinterpret_cast<uint64_t*>(s->base + off) = bsize;
        data_off = off + sizeof(uint64_t);
      }
      return data_off;
    }
    prev_off = off;
    off = b->next_off;
  }
  return 0;
}

void heap_free(Store* s, uint64_t data_off) {
  uint64_t block_off = data_off - sizeof(uint64_t);
  uint64_t bsize = *reinterpret_cast<uint64_t*>(s->base + block_off);
  // insert sorted by offset, coalesce neighbors
  uint64_t prev = 0, cur = s->hdr->free_head;
  while (cur && cur < block_off) {
    prev = cur;
    cur = reinterpret_cast<FreeBlock*>(s->base + cur)->next_off;
  }
  FreeBlock* nb = reinterpret_cast<FreeBlock*>(s->base + block_off);
  nb->size = bsize;
  nb->next_off = cur;
  if (prev) {
    reinterpret_cast<FreeBlock*>(s->base + prev)->next_off = block_off;
  } else {
    s->hdr->free_head = block_off;
  }
  // coalesce with next
  if (cur && block_off + nb->size == cur) {
    FreeBlock* cb = reinterpret_cast<FreeBlock*>(s->base + cur);
    nb->size += cb->size;
    nb->next_off = cb->next_off;
  }
  // coalesce with prev
  if (prev) {
    FreeBlock* pb = reinterpret_cast<FreeBlock*>(s->base + prev);
    if (prev + pb->size == block_off) {
      pb->size += nb->size;
      pb->next_off = nb->next_off;
    }
  }
}

// Evict LRU sealed objects with refcount==0 until at least `need` bytes are
// freed. One scan collects all candidates, sorts by LRU tick, then evicts in
// order — victims are re-located by id because rehash_cluster moves entries
// (reference design: intrusive LRU list in plasma/eviction_policy.h).
uint64_t evict_lru(Store* s, uint64_t need) {
  struct Cand {
    uint64_t tick;
    uint64_t size;
    uint8_t id[kIdSize];
  };
  std::vector<Cand> cands;
  for (uint64_t i = 0; i < s->hdr->capacity; i++) {
    ObjectEntry* e = &s->table[i];
    if (e->state == kEntrySealed && e->refcount == 0) {
      Cand c;
      c.tick = e->lru_tick;
      c.size = e->data_size;
      memcpy(c.id, e->id, kIdSize);
      cands.push_back(c);
    }
  }
  std::sort(cands.begin(), cands.end(),
            [](const Cand& a, const Cand& b) { return a.tick < b.tick; });
  uint64_t freed = 0;
  for (const Cand& c : cands) {
    if (freed >= need) break;
    ObjectEntry* e = find_entry(s, c.id, false);
    if (e == nullptr || e->state != kEntrySealed || e->refcount != 0) continue;
    freed += e->data_size;
    s->hdr->bytes_in_use -= e->data_size;
    s->hdr->num_objects--;
    heap_free(s, e->offset);
    uint64_t idx = (uint64_t)(e - s->table);
    e->state = kEntryFree;
    rehash_cluster(s, idx);
  }
  return freed;
}

}  // namespace

extern "C" {

// Error codes
enum {
  RT_OK = 0,
  RT_ERR_EXISTS = -1,
  RT_ERR_NOT_FOUND = -2,
  RT_ERR_FULL = -3,
  RT_ERR_STATE = -4,
  RT_ERR_SYS = -5,
};

void* rt_store_create(const char* name, uint64_t size, uint64_t capacity) {
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t table_bytes = capacity * sizeof(ObjectEntry);
  uint64_t total = align8(sizeof(StoreHeader)) + align8(table_bytes) + size;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Store* s = new Store();
  s->base = static_cast<uint8_t*>(base);
  s->map_size = total;
  s->fd = fd;
  s->hdr = reinterpret_cast<StoreHeader*>(base);
  memset(s->hdr, 0, sizeof(StoreHeader));
  s->hdr->magic = kMagic;
  s->hdr->total_size = total;
  s->hdr->capacity = capacity;
  s->hdr->heap_offset = align8(sizeof(StoreHeader)) + align8(table_bytes);
  s->hdr->heap_size = size;
  s->table = reinterpret_cast<ObjectEntry*>(s->base + align8(sizeof(StoreHeader)));
  memset(s->table, 0, table_bytes);
  // init heap: one big free block
  FreeBlock* fb = reinterpret_cast<FreeBlock*>(s->base + s->hdr->heap_offset);
  fb->size = size;
  fb->next_off = 0;
  s->hdr->free_head = s->hdr->heap_offset;
  // robust process-shared mutex
  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&s->hdr->lock, &attr);
  // tsan: seq_cst init store — runs before the segment name is returned to
  // any peer, so no concurrent observer exists yet.
  s->hdr->seal_seq.store(0);
  return s;
}

void* rt_store_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Store* s = new Store();
  s->base = static_cast<uint8_t*>(base);
  s->map_size = (uint64_t)st.st_size;
  s->fd = fd;
  s->hdr = reinterpret_cast<StoreHeader*>(base);
  if (s->hdr->magic != kMagic) {
    munmap(base, s->map_size);
    close(fd);
    delete s;
    return nullptr;
  }
  s->table = reinterpret_cast<ObjectEntry*>(
      s->base + align8(sizeof(StoreHeader)));
  return s;
}

void rt_store_close(void* handle) {
  Store* s = static_cast<Store*>(handle);
  munmap(s->base, s->map_size);
  close(s->fd);
  delete s;
}

void rt_store_destroy(const char* name) { shm_unlink(name); }

// Allocates space for an object. On success *out_offset is the byte offset of
// the data region from the mapped base (stable across processes).
// allow_evict=0 makes a failed allocation return RT_ERR_FULL instead of
// destroying LRU objects — required when the node daemon spills under
// pressure (eviction would delete sole copies the spiller could have saved;
// reference: plasma eviction is only safe because raylet spills first).
int rt_object_create_ex(void* handle, const uint8_t* id, uint64_t data_size,
                        uint64_t metadata, int allow_evict,
                        uint64_t* out_offset) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  ObjectEntry* e = find_entry(s, id, true);
  if (e == nullptr) return RT_ERR_FULL;  // table full
  if (e->state != kEntryFree) return RT_ERR_EXISTS;
  uint64_t off = heap_alloc(s, data_size ? data_size : 8);
  if (off == 0) {
    if (!allow_evict) return RT_ERR_FULL;
    evict_lru(s, data_size + 64);
    off = heap_alloc(s, data_size ? data_size : 8);
    if (off == 0) return RT_ERR_FULL;
    e = find_entry(s, id, true);  // eviction may have moved slots
    if (e == nullptr) return RT_ERR_FULL;
    if (e->state != kEntryFree) return RT_ERR_EXISTS;
  }
  memcpy(e->id, id, kIdSize);
  e->state = kEntryCreated;
  e->refcount = 1;  // creator holds a ref until seal+release
  e->data_size = data_size;
  e->offset = off;
  e->metadata = metadata;
  e->lru_tick = ++s->hdr->lru_clock;
  s->hdr->bytes_in_use += data_size;
  s->hdr->num_objects++;
  *out_offset = off;
  return RT_OK;
}

int rt_object_create(void* handle, const uint8_t* id, uint64_t data_size,
                     uint64_t metadata, uint64_t* out_offset) {
  return rt_object_create_ex(handle, id, data_size, metadata, /*allow_evict=*/1,
                             out_offset);
}

int rt_object_seal(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  ObjectEntry* e = find_entry(s, id, false);
  if (e == nullptr) return RT_ERR_NOT_FOUND;
  if (e->state != kEntryCreated) return RT_ERR_STATE;
  e->state = kEntrySealed;
  e->refcount -= 1;  // drop creator ref
  // tsan: seq_cst bump under the Guard; ordered after the state flip above
  // so a lock-free poller that sees the new seq can safely take the lock
  // and find the object sealed.
  s->hdr->seal_seq.fetch_add(1);
  return RT_OK;
}

// Get a sealed object; bumps refcount (pin). Returns offset+size+metadata.
int rt_object_get(void* handle, const uint8_t* id, uint64_t* out_offset,
                  uint64_t* out_size, uint64_t* out_metadata) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  ObjectEntry* e = find_entry(s, id, false);
  if (e == nullptr || e->state != kEntrySealed) return RT_ERR_NOT_FOUND;
  e->refcount++;
  e->lru_tick = ++s->hdr->lru_clock;
  *out_offset = e->offset;
  *out_size = e->data_size;
  *out_metadata = e->metadata;
  return RT_OK;
}

int rt_object_release(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  ObjectEntry* e = find_entry(s, id, false);
  if (e == nullptr) return RT_ERR_NOT_FOUND;
  if (e->refcount > 0) e->refcount--;
  return RT_OK;
}

int rt_object_contains(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  ObjectEntry* e = find_entry(s, id, false);
  return (e != nullptr && e->state == kEntrySealed) ? 1 : 0;
}

int rt_object_delete(void* handle, const uint8_t* id) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  ObjectEntry* e = find_entry(s, id, false);
  if (e == nullptr) return RT_ERR_NOT_FOUND;
  if (e->refcount > 0) return RT_ERR_STATE;  // pinned
  uint64_t idx = (uint64_t)(e - s->table);
  s->hdr->bytes_in_use -= e->data_size;
  s->hdr->num_objects--;
  heap_free(s, e->offset);
  e->state = kEntryFree;
  rehash_cluster(s, idx);
  return RT_OK;
}

// List spill/eviction candidates (sealed, unpinned), LRU-first. Fills up to
// max_n ids (kIdSize bytes each) and sizes; returns the count written. Used
// by the node daemon's spill loop (reference: local_object_manager.h:45
// SpillObjectsOfSize choosing from the eviction policy's LRU order).
uint64_t rt_store_list_evictable(void* handle, uint8_t* out_ids,
                                 uint64_t* out_sizes, uint64_t max_n) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  struct Cand {
    uint64_t tick;
    uint64_t size;
    const uint8_t* id;
  };
  std::vector<Cand> cands;
  for (uint64_t i = 0; i < s->hdr->capacity; i++) {
    ObjectEntry* e = &s->table[i];
    if (e->state == kEntrySealed && e->refcount == 0) {
      cands.push_back({e->lru_tick, e->data_size, e->id});
    }
  }
  std::sort(cands.begin(), cands.end(),
            [](const Cand& a, const Cand& b) { return a.tick < b.tick; });
  uint64_t n = std::min<uint64_t>(cands.size(), max_n);
  for (uint64_t i = 0; i < n; i++) {
    memcpy(out_ids + i * kIdSize, cands[i].id, kIdSize);
    out_sizes[i] = cands[i].size;
  }
  return n;
}

void rt_store_stats(void* handle, uint64_t* bytes_in_use, uint64_t* num_objects,
                    uint64_t* heap_size, uint64_t* seal_seq) {
  Store* s = static_cast<Store*>(handle);
  Guard g(s->hdr);
  *bytes_in_use = s->hdr->bytes_in_use;
  *num_objects = s->hdr->num_objects;
  *heap_size = s->hdr->heap_size;
  *seal_seq = s->hdr->seal_seq.load();
}

uint8_t* rt_store_base(void* handle) {
  return static_cast<Store*>(handle)->base;
}

uint64_t rt_store_map_size(void* handle) {
  return static_cast<Store*>(handle)->map_size;
}

}  // extern "C"
