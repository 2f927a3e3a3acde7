// ray_tpu_torch native shared-memory object store ("hbmstore host tier").
//
// TPU-native re-design of the reference's Plasma store
// (reference: src/ray/object_manager/plasma/store.h:55,
//  object_lifecycle_manager.h, eviction_policy.h, dlmalloc.cc).
//
// Key design departure from Plasma: instead of a store *server* process that
// clients talk to over a unix socket with fd-passing (plasma/client.cc,
// plasma/fling.cc), the entire store state — object index, allocator free
// list, refcounts, LRU clock — lives inside one POSIX shared-memory segment
// guarded by a process-shared robust mutex. Every process on the node maps
// the segment once and then performs create/seal/get/release directly in
// shared memory with no IPC round trip on the hot path. This removes the
// socket hop that dominates Plasma's small-object latency and suits TPU
// hosts, where the store's main job is staging host-side buffers for
// jax.device_put / device_get (the HBM tier itself is tracked per-process by
// the Python runtime, since XLA owns device allocations).
//
// Capabilities kept from the reference:
//   - immutable sealed objects addressed by 20-byte ObjectIDs
//     (src/ray/common/id.h)
//   - pin/unpin refcounts and LRU eviction of unpinned sealed objects
//     (plasma/eviction_policy.h)
//   - create -> write -> seal protocol for zero-copy producers
//   - delete + free-space accounting
//
// Concurrency: a single process-shared PTHREAD_MUTEX_ROBUST mutex. Robustness
// matters: a worker killed mid-operation must not deadlock the node
// (the reference survives this because the store is a separate process; we
// survive it via EOWNERDEAD recovery).
//
// Built as a plain C ABI shared library; Python binds via ctypes
// (ray_tpu_torch/core/object_store.py) and maps the same segment with mmap for
// zero-copy numpy views.

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <new>

namespace {

// Layout version is baked into the magic: bump the low byte whenever
// Entry/Header change so a process built against a different layout
// fails attach instead of silently corrupting a live segment.
constexpr uint64_t kMagic = 0x5250555453544F02ULL;  // "RPUTSTO" + v2
constexpr uint32_t kIdLen = 20;

enum ObjState : uint32_t {
  kFree = 0,
  kCreating = 1,
  kSealed = 2,
};

struct Entry {
  uint8_t id[kIdLen];
  uint32_t state;
  uint32_t pending_delete;  // delete arrived while pinned; freed on last release
  uint64_t offset;    // into heap
  uint64_t size;      // user payload size
  uint64_t capacity;  // allocated block size (>= size)
  int64_t refcount;   // pin count; evictable iff 0 and sealed
  uint64_t lru_tick;
  uint64_t create_ts;  // wall seconds at kCreating entry; orphan reaping
};

struct FreeBlock {
  uint64_t offset;
  uint64_t size;
  int32_t next;  // index into free block array, -1 end
  int32_t used;  // slot in use
};

struct Header {
  uint64_t magic;
  pthread_mutex_t mutex;
  uint64_t capacity;      // heap bytes
  uint64_t heap_start;    // offset of heap from segment base
  uint64_t bytes_in_use;  // allocated bytes
  uint64_t tick;          // LRU clock
  uint32_t max_objects;
  uint32_t num_objects;
  uint32_t max_free_blocks;
  int32_t free_head;  // free-list head index
  uint64_t num_evictions;
  uint64_t bytes_evicted;
  // Entry[max_objects], FreeBlock[max_free_blocks] follow, then heap.
};

struct Store {
  Header* hdr;
  uint8_t* base;
  uint64_t mapped_size;
  char name[256];
};

inline Entry* entries(Header* h) {
  return reinterpret_cast<Entry*>(reinterpret_cast<uint8_t*>(h) + sizeof(Header));
}
inline FreeBlock* free_blocks(Header* h) {
  return reinterpret_cast<FreeBlock*>(
      reinterpret_cast<uint8_t*>(entries(h)) + sizeof(Entry) * h->max_objects);
}

uint64_t id_hash(const uint8_t* id) {
  // FNV-1a over the 20-byte id.
  uint64_t v = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdLen; i++) {
    v ^= id[i];
    v *= 1099511628211ULL;
  }
  return v;
}

// Open-addressed lookup. Returns entry with matching id, or the first free
// slot if absent (insert position), or nullptr if table full and absent.
Entry* find_slot(Header* h, const uint8_t* id, bool for_insert) {
  Entry* tab = entries(h);
  uint64_t mask = h->max_objects - 1;  // max_objects is a power of two
  uint64_t idx = id_hash(id) & mask;
  Entry* first_free = nullptr;
  for (uint32_t probe = 0; probe < h->max_objects; probe++) {
    Entry* e = &tab[(idx + probe) & mask];
    if (e->state == kFree) {
      if (first_free == nullptr) first_free = e;
      // Freed slots keep capacity != 0 and act as tombstones: they do not
      // terminate a probe chain. A never-used slot (capacity == 0) proves the
      // id is absent, bounding both lookups and inserts.
      if (e->capacity == 0) return for_insert ? first_free : nullptr;
      continue;
    }
    if (memcmp(e->id, id, kIdLen) == 0) return e;
  }
  return for_insert ? first_free : nullptr;
}

int lock(Header* h) {
  int rc = pthread_mutex_lock(&h->mutex);
  if (rc == EOWNERDEAD) {
    // Previous holder died. State may be mid-mutation, but all mutations keep
    // the index structurally valid (single-word state transitions last).
    pthread_mutex_consistent(&h->mutex);
    rc = 0;
  }
  return rc;
}
void unlock(Header* h) { pthread_mutex_unlock(&h->mutex); }

// --- allocator: first-fit free list with coalescing -------------------------

int32_t alloc_free_slot(Header* h) {
  FreeBlock* fb = free_blocks(h);
  for (uint32_t i = 0; i < h->max_free_blocks; i++) {
    if (!fb[i].used) return (int32_t)i;
  }
  return -1;
}

// Allocate `size` bytes from the heap; returns offset or 0 on failure.
// Offset 0 is never a valid allocation because heap offsets returned are
// relative to segment base and the heap starts after the header.
uint64_t heap_alloc(Header* h, uint64_t size) {
  size = (size + 63) & ~63ULL;  // 64-byte alignment for numpy/dlpack friendliness
  if (size == 0) size = 64;
  FreeBlock* fb = free_blocks(h);
  int32_t prev = -1;
  for (int32_t cur = h->free_head; cur != -1; prev = cur, cur = fb[cur].next) {
    if (fb[cur].size >= size) {
      uint64_t off = fb[cur].offset;
      if (fb[cur].size == size) {
        if (prev == -1) h->free_head = fb[cur].next;
        else fb[prev].next = fb[cur].next;
        fb[cur].used = 0;
      } else {
        fb[cur].offset += size;
        fb[cur].size -= size;
      }
      h->bytes_in_use += size;
      return off;
    }
  }
  return 0;
}

void heap_free(Header* h, uint64_t offset, uint64_t size) {
  size = (size + 63) & ~63ULL;
  if (size == 0) size = 64;
  h->bytes_in_use -= size;
  FreeBlock* fb = free_blocks(h);
  // Insert sorted by offset, coalescing with neighbors.
  int32_t prev = -1, cur = h->free_head;
  while (cur != -1 && fb[cur].offset < offset) {
    prev = cur;
    cur = fb[cur].next;
  }
  // Try coalesce with prev.
  if (prev != -1 && fb[prev].offset + fb[prev].size == offset) {
    fb[prev].size += size;
    // Coalesce prev with cur too?
    if (cur != -1 && fb[prev].offset + fb[prev].size == fb[cur].offset) {
      fb[prev].size += fb[cur].size;
      fb[prev].next = fb[cur].next;
      fb[cur].used = 0;
    }
    return;
  }
  // Try coalesce with cur.
  if (cur != -1 && offset + size == fb[cur].offset) {
    fb[cur].offset = offset;
    fb[cur].size += size;
    return;
  }
  int32_t slot = alloc_free_slot(h);
  if (slot == -1) {
    // Free-list exhaustion leaks the block until destroy; extremely unlikely
    // with max_free_blocks == max_objects.
    return;
  }
  fb[slot].used = 1;
  fb[slot].offset = offset;
  fb[slot].size = size;
  fb[slot].next = cur;
  if (prev == -1) h->free_head = slot;
  else fb[prev].next = slot;
}

}  // namespace

extern "C" {

// Create a new store segment. capacity = heap bytes; max_objects rounded up
// to a power of two. Returns opaque handle or null.
void* ts_create(const char* name, uint64_t capacity, uint32_t max_objects) {
  uint32_t mo = 1;
  while (mo < max_objects) mo <<= 1;
  uint64_t meta = sizeof(Header) + (uint64_t)mo * sizeof(Entry) +
                  (uint64_t)mo * sizeof(FreeBlock);
  meta = (meta + 4095) & ~4095ULL;
  uint64_t total = meta + capacity;

  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  Header* h = reinterpret_cast<Header*>(base);
  memset(h, 0, sizeof(Header));
  h->capacity = capacity;
  h->heap_start = meta;
  h->max_objects = mo;
  h->max_free_blocks = mo;
  h->free_head = -1;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mutex, &attr);
  pthread_mutexattr_destroy(&attr);

  // One big free block spanning the heap. Heap offsets are relative to
  // segment base; block at heap_start.
  FreeBlock* fb = free_blocks(h);
  fb[0].used = 1;
  fb[0].offset = meta;
  fb[0].size = capacity;
  fb[0].next = -1;
  h->free_head = 0;

  h->magic = kMagic;  // publish last

  Store* s = new (std::nothrow) Store;
  if (!s) return nullptr;
  s->hdr = h;
  s->base = reinterpret_cast<uint8_t*>(base);
  s->mapped_size = total;
  snprintf(s->name, sizeof(s->name), "%s", name);
  return s;
}

void* ts_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base =
      mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  Header* h = reinterpret_cast<Header*>(base);
  if (h->magic != kMagic) {
    munmap(base, (size_t)st.st_size);
    return nullptr;
  }
  Store* s = new (std::nothrow) Store;
  if (!s) return nullptr;
  s->hdr = h;
  s->base = reinterpret_cast<uint8_t*>(base);
  s->mapped_size = (uint64_t)st.st_size;
  snprintf(s->name, sizeof(s->name), "%s", name);
  return s;
}

void ts_detach(void* sp) {
  Store* s = reinterpret_cast<Store*>(sp);
  if (!s) return;
  munmap(s->base, s->mapped_size);
  delete s;
}

void ts_destroy(const char* name) { shm_unlink(name); }

uint64_t ts_total_size(void* sp) {
  return reinterpret_cast<Store*>(sp)->mapped_size;
}

// Reserve a buffer for object `id` of `size` bytes. Returns offset into the
// segment where the caller writes payload, or 0 on failure (-> errno-style
// result via ts_last style omitted; 0 covers exists/full). The object stays
// kCreating (invisible to get) until ts_seal.
uint64_t ts_create_buf(void* sp, const uint8_t* id, uint64_t size) {
  Store* s = reinterpret_cast<Store*>(sp);
  Header* h = s->hdr;
  if (lock(h) != 0) return 0;
  Entry* e = find_slot(h, id, true);
  if (e == nullptr || (e->state != kFree && memcmp(e->id, id, kIdLen) == 0)) {
    unlock(h);
    return 0;  // table full or already exists
  }
  uint64_t off = heap_alloc(h, size);
  if (off == 0) {
    // Evict and retry.
    Entry* tab = entries(h);
    for (;;) {
      Entry* victim = nullptr;
      for (uint32_t i = 0; i < h->max_objects; i++) {
        Entry* ev = &tab[i];
        if (ev->state == kSealed && ev->refcount <= 0) {
          if (victim == nullptr || ev->lru_tick < victim->lru_tick) victim = ev;
        }
      }
      if (victim == nullptr) break;
      heap_free(h, victim->offset, victim->capacity);
      h->num_evictions++;
      h->bytes_evicted += victim->size;
      victim->state = kFree;
      h->num_objects--;
      off = heap_alloc(h, size);
      if (off != 0) break;
    }
    if (off == 0) {
      unlock(h);
      return 0;
    }
    // Eviction may have freed the slot we held (it cannot: victim entries are
    // distinct from the free slot we got), but re-find for safety.
    e = find_slot(h, id, true);
    if (e == nullptr) {
      heap_free(h, off, size);
      unlock(h);
      return 0;
    }
  }
  memcpy(e->id, id, kIdLen);
  e->state = kCreating;
  e->pending_delete = 0;
  e->create_ts = (uint64_t)time(nullptr);
  e->offset = off;
  e->size = size;
  e->capacity = size;
  e->refcount = 1;  // creator holds a pin until seal/abort
  e->lru_tick = ++h->tick;
  h->num_objects++;
  unlock(h);
  return off;
}

int ts_seal(void* sp, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(sp);
  Header* h = s->hdr;
  if (lock(h) != 0) return -1;
  Entry* e = find_slot(h, id, false);
  if (e == nullptr || e->state != kCreating) {
    unlock(h);
    return -1;
  }
  if (e->pending_delete) {
    // deleted while still being written: finish as a free, not a seal
    heap_free(h, e->offset, e->capacity);
    e->state = kFree;
    e->pending_delete = 0;
    h->num_objects--;
    unlock(h);
    return 0;
  }
  e->state = kSealed;
  e->refcount = 0;  // creator pin released; caller re-pins via ts_get if needed
  e->lru_tick = ++h->tick;
  unlock(h);
  return 0;
}

int ts_abort(void* sp, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(sp);
  Header* h = s->hdr;
  if (lock(h) != 0) return -1;
  Entry* e = find_slot(h, id, false);
  if (e == nullptr || e->state != kCreating) {
    unlock(h);
    return -1;
  }
  heap_free(h, e->offset, e->capacity);
  e->state = kFree;
  h->num_objects--;
  unlock(h);
  return 0;
}

// One-shot put: create + copy + seal.
// Returns 0 ok, -1 exists, -2 out of memory.
int ts_put(void* sp, const uint8_t* id, const void* data, uint64_t size) {
  Store* s = reinterpret_cast<Store*>(sp);
  {
    Header* h = s->hdr;
    if (lock(h) != 0) return -2;
    Entry* e = find_slot(h, id, false);
    if (e != nullptr && e->state != kFree) {
      unlock(h);
      return -1;
    }
    unlock(h);
  }
  uint64_t off = ts_create_buf(sp, id, size);
  if (off == 0) return -2;
  memcpy(s->base + off, data, size);
  return ts_seal(sp, id);
}

// Pin + locate. Returns offset (0 if absent/unsealed); size via out param.
uint64_t ts_get(void* sp, const uint8_t* id, uint64_t* size_out) {
  Store* s = reinterpret_cast<Store*>(sp);
  Header* h = s->hdr;
  if (lock(h) != 0) return 0;
  Entry* e = find_slot(h, id, false);
  if (e == nullptr || e->state != kSealed || e->pending_delete) {
    unlock(h);
    return 0;
  }
  e->refcount++;
  e->lru_tick = ++h->tick;
  uint64_t off = e->offset;
  if (size_out) *size_out = e->size;
  unlock(h);
  return off;
}

int ts_release(void* sp, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(sp);
  Header* h = s->hdr;
  if (lock(h) != 0) return -1;
  Entry* e = find_slot(h, id, false);
  if (e == nullptr || e->state != kSealed) {
    unlock(h);
    return -1;
  }
  if (e->refcount > 0) e->refcount--;
  if (e->refcount == 0 && e->pending_delete) {
    heap_free(h, e->offset, e->capacity);
    e->state = kFree;
    e->pending_delete = 0;
    h->num_objects--;
  }
  unlock(h);
  return 0;
}

int ts_contains(void* sp, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(sp);
  Header* h = s->hdr;
  if (lock(h) != 0) return 0;
  Entry* e = find_slot(h, id, false);
  int r = (e != nullptr && e->state == kSealed && !e->pending_delete)
              ? 1 : 0;
  unlock(h);
  return r;
}

// Delete an object. If it is pinned (a reader holds a view, or the
// native transfer plane is mid-send), the free is DEFERRED to the last
// ts_release — freeing the heap region under an active reader would let
// a concurrent allocation reuse it and corrupt the bytes in flight.
// Unpinned objects free immediately (LocalObjectManager free semantics).
int ts_delete(void* sp, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(sp);
  Header* h = s->hdr;
  if (lock(h) != 0) return -1;
  Entry* e = find_slot(h, id, false);
  if (e == nullptr || e->state == kFree) {
    unlock(h);
    return -1;
  }
  if (e->refcount > 0) {
    e->pending_delete = 1;
    unlock(h);
    return 0;
  }
  heap_free(h, e->offset, e->capacity);
  e->state = kFree;
  e->pending_delete = 0;
  h->num_objects--;
  unlock(h);
  return 0;
}

// Enumerate sealed objects, least-recently-used first (the spill candidate
// order). Fills ids_out (max*20 bytes), sizes_out and pins_out (max each);
// returns the count written. Snapshot under the lock; callers must tolerate
// entries vanishing (eviction) between the snapshot and any follow-up call.
uint32_t ts_list(void* sp, uint8_t* ids_out, uint64_t* sizes_out,
                 int64_t* pins_out, uint32_t max) {
  Store* s = reinterpret_cast<Store*>(sp);
  Header* h = s->hdr;
  // Snapshot under the lock (O(n) copy), sort outside it — keeps the
  // cross-process critical section short even with many sealed objects.
  struct Item {
    uint8_t id[kIdLen];
    uint64_t size;
    int64_t pins;
    uint64_t tick;
  };
  if (lock(h) != 0) return 0;
  uint32_t total = h->num_objects;
  Item* items = new (std::nothrow) Item[total ? total : 1];
  if (items == nullptr) {
    unlock(h);
    return 0;
  }
  Entry* tab = entries(h);
  uint32_t n = 0;
  for (uint32_t i = 0; i < h->max_objects && n < total; i++) {
    Entry* e = &tab[i];
    if (e->state != kSealed) continue;
    memcpy(items[n].id, e->id, kIdLen);
    items[n].size = e->size;
    items[n].pins = e->refcount;
    items[n].tick = e->lru_tick;
    n++;
  }
  unlock(h);
  std::sort(items, items + n,
            [](const Item& a, const Item& b) { return a.tick < b.tick; });
  if (n > max) n = max;
  for (uint32_t i = 0; i < n; i++) {
    memcpy(ids_out + (uint64_t)i * kIdLen, items[i].id, kIdLen);
    sizes_out[i] = items[i].size;
    pins_out[i] = items[i].pins;
  }
  delete[] items;
  return n;
}

// Atomically free a sealed object iff its current pin count is <= max_pins
// (the caller's own pins). Returns 1 freed, 0 still pinned by readers,
// -1 absent/unsealed. This is the safe spill-eviction primitive: the
// decision and the free happen under one lock, so a reader pinning between
// a stale snapshot and the delete can never be invalidated (the bug class
// ts_delete's refcount-ignoring contract would allow).
int ts_evict(void* sp, const uint8_t* id, int64_t max_pins) {
  Store* s = reinterpret_cast<Store*>(sp);
  Header* h = s->hdr;
  if (lock(h) != 0) return -1;
  Entry* e = find_slot(h, id, false);
  if (e == nullptr || e->state != kSealed) {
    unlock(h);
    return -1;
  }
  if (e->refcount > max_pins) {
    unlock(h);
    return 0;
  }
  heap_free(h, e->offset, e->capacity);
  e->state = kFree;
  h->num_objects--;
  unlock(h);
  return 1;
}

uint64_t ts_bytes_in_use(void* sp) {
  Store* s = reinterpret_cast<Store*>(sp);
  return s->hdr->bytes_in_use;
}
uint64_t ts_capacity(void* sp) { return reinterpret_cast<Store*>(sp)->hdr->capacity; }
uint32_t ts_num_objects(void* sp) {
  return reinterpret_cast<Store*>(sp)->hdr->num_objects;
}
uint64_t ts_num_evictions(void* sp) {
  return reinterpret_cast<Store*>(sp)->hdr->num_evictions;
}

// Segment base pointer, for in-process zero-copy consumers of ts_get
// offsets (the native transfer plane in xfer.cc reads/writes the heap
// directly: shm -> socket with no userspace staging buffer).
void* ts_seg_base(void* sp) { return reinterpret_cast<Store*>(sp)->base; }

// Reap kCreating entries older than max_age_s: a producer SIGKILLed
// mid-write leaves its buffer orphaned forever (nothing seals or aborts
// it), making the object permanently unfetchable on this node. Live
// writers are safe at sane ages — local writes finish in seconds and
// the transfer plane's socket timeout (120s) bounds remote ones.
// Returns the number of entries freed.
int ts_reap_creating(void* sp, uint64_t max_age_s) {
  Store* s = reinterpret_cast<Store*>(sp);
  Header* h = s->hdr;
  if (lock(h) != 0) return 0;
  uint64_t now = (uint64_t)time(nullptr);
  Entry* tab = entries(h);
  int n = 0;
  for (uint32_t i = 0; i < h->max_objects; i++) {
    Entry* e = &tab[i];
    if (e->state == kCreating && e->create_ts + max_age_s <= now) {
      heap_free(h, e->offset, e->capacity);
      e->state = kFree;
      e->pending_delete = 0;
      h->num_objects--;
      n++;
    }
  }
  unlock(h);
  return n;
}

// Heartbeat a kCreating entry: a long-running writer (the transfer
// plane's chunked receive) refreshes create_ts so the orphan reaper
// never frees a buffer that is actively receiving bytes.
int ts_touch_creating(void* sp, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(sp);
  Header* h = s->hdr;
  if (lock(h) != 0) return -1;
  Entry* e = find_slot(h, id, false);
  int r = -1;
  if (e != nullptr && e->state == kCreating) {
    e->create_ts = (uint64_t)time(nullptr);
    r = 0;
  }
  unlock(h);
  return r;
}

// CRASH-TEST HOOK: acquire the robust mutex, touch `marker_path` to tell
// the test harness the lock is held, then sleep. The harness SIGKILLs
// this process mid-sleep, so the next lock() in any surviving process
// must take the EOWNERDEAD path (tests/test_native_crash.py). Never used
// by production code — it exists because killing a process at exactly
// the right instant is otherwise nondeterministic.
int ts_debug_lock_hold(void* sp, const char* marker_path, uint32_t millis) {
  Store* s = reinterpret_cast<Store*>(sp);
  Header* h = s->hdr;
  if (lock(h) != 0) return -1;
  FILE* f = fopen(marker_path, "w");
  if (f != nullptr) fclose(f);
  struct timespec ts = {millis / 1000, (long)(millis % 1000) * 1000000L};
  nanosleep(&ts, nullptr);
  unlock(h);
  return 0;
}

// Entry state probe: 0 = absent, 1 = creating (a racing producer/puller
// is mid-write), 2 = sealed. Lets the transfer plane distinguish
// "already here / arriving" from "allocation failed".
int ts_state(void* sp, const uint8_t* id) {
  Store* s = reinterpret_cast<Store*>(sp);
  Header* h = s->hdr;
  if (lock(h) != 0) return 0;
  Entry* e = find_slot(h, id, false);
  int r = 0;
  if (e != nullptr && e->state == kCreating) r = 1;
  if (e != nullptr && e->state == kSealed && !e->pending_delete) r = 2;
  unlock(h);
  return r;
}

}  // extern "C"
