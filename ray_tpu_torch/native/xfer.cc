// ray_tpu_torch native object-transfer plane.
//
// TPU-native equivalent of the reference's C++ object manager data path
// (reference: src/ray/object_manager/object_manager.cc:338 Push /
// :561 HandlePush — 64MiB-chunk gRPC streams between raylets). Design
// departure: instead of chunked RPC frames through the control-plane
// stack (which costs a pickle + two userspace copies per chunk in the
// Python nodelet), this is a dedicated TCP plane that writes straight
// from the shared-memory heap to the socket and reads straight from the
// socket into a freshly allocated shm buffer — zero userspace staging on
// both ends; the kernel does the only copies. The Python pull path
// (core/nodelet.py rpc_pull_object) uses it when available and falls
// back to the portable chunk RPC for spilled objects or native-disabled
// stores.
//
// Wire protocol (one TCP connection per fetch; requests may be pipelined
// sequentially on a kept-open connection):
//   request:  [20-byte object id]
//   response: [u64 little-endian total] [payload bytes]
//             total == UINT64_MAX -> object not present at the source.
//
// Concurrency: one detached listener thread; one detached thread per
// accepted connection (transfer counts are small — tens of hosts — and
// each transfer is long; thread-per-connection is the simple correct
// shape). The sealed object is pinned (ts_get) for the duration of the
// send so eviction cannot unmap it mid-write.

#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

// Public C ABI of the store (objstore.cc, linked into the same .so).
extern "C" {
uint64_t ts_get(void* sp, const uint8_t* id, uint64_t* size_out);
int ts_release(void* sp, const uint8_t* id);
uint64_t ts_create_buf(void* sp, const uint8_t* id, uint64_t size);
int ts_seal(void* sp, const uint8_t* id);
int ts_abort(void* sp, const uint8_t* id);
void* ts_seg_base(void* sp);
int ts_state(void* sp, const uint8_t* id);
int ts_touch_creating(void* sp, const uint8_t* id);
}

namespace {

constexpr uint32_t kIdLen = 20;
constexpr uint64_t kAbsent = ~0ULL;
// "source saturated" reply: the puller should retry (possibly against a
// peer that registered a copy in the meantime) instead of queueing here.
// A broadcast fan-in then cascades through fresh holders rather than
// serializing every transfer behind one source NIC/core (ref: pull
// manager fan-out across holders, pull_manager.h:52).
constexpr uint64_t kBusy = ~0ULL - 1;
constexpr int kIoTimeoutSec = 120;

struct ServerState {
  int listen_fd = -1;
  void* store = nullptr;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> generation{0};  // guards stale listener threads
};

ServerState g_server;

// Outbound-serve throttle: at most g_serve_cap payloads of THE SAME
// object in flight (0 = unlimited). Excess requests get kBusy instead of
// a queue slot. Per-object, not global: a broadcast fan-in of one hot
// object should cascade through peer holders, but pulls of DISTINCT
// objects from one node must keep multiplexing freely.
std::atomic<int> g_serve_cap{0};
std::atomic<uint64_t> g_busy_rejections{0};
std::mutex g_serve_mu;
std::unordered_map<std::string, int> g_active_by_id;

// Connection registry. ts_xfer_serve_stop() MUST NOT return while any
// sender thread can still touch the shm heap or the Store handle: the
// caller's next move is ts_detach (munmap + delete Store), and a sender
// still inside write_exact()/ts_release() would segfault on the unmapped
// segment — the exact delete-race crash the round-3 suite reproduced.
// Every handler thread (and the listener) registers here; stop() shuts
// down all live conn fds (aborting blocked reads/writes immediately) and
// drains the registry before returning.
std::mutex g_conn_mu;
std::condition_variable g_conn_cv;
std::vector<int> g_conn_fds;  // fds whose handler thread is still live
int g_live_threads = 0;       // handler threads + listener thread

void set_timeouts(int fd) {
  struct timeval tv;
  tv.tv_sec = kIoTimeoutSec;
  tv.tv_usec = 0;
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  // big socket buffers: bulk transfers must not ping-pong on the default
  // ~16KB windows (dominates on single-core hosts where sender and
  // receiver share the CPU)
  int buf = 4 << 20;
  setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
}

bool read_exact(int fd, void* buf, uint64_t n) {
  uint8_t* p = reinterpret_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = read(fd, p, n);
    if (r < 0 && errno == EINTR) continue;  // signals must not kill a
    if (r <= 0) return false;               // multi-GB transfer
    p += r;
    n -= (uint64_t)r;
  }
  return true;
}

bool write_exact(int fd, const void* buf, uint64_t n) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(buf);
  while (n > 0) {
    // cap single write() calls; very large writes can spuriously EINVAL
    // on some stacks and 8MiB keeps send-buffer pressure smooth
    uint64_t chunk = n > (8ULL << 20) ? (8ULL << 20) : n;
    ssize_t w = write(fd, p, chunk);
    if (w < 0 && errno == EINTR) continue;
    if (w <= 0) return false;
    p += w;
    n -= (uint64_t)w;
  }
  return true;
}

void handle_conn(int fd, void* store) {
  set_timeouts(fd);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  uint8_t id[kIdLen];
  while (read_exact(fd, id, kIdLen)) {
    uint64_t size = 0;
    uint64_t off = ts_get(store, id, &size);
    if (off == 0) {
      uint64_t absent = kAbsent;
      if (!write_exact(fd, &absent, sizeof(absent))) break;
      continue;
    }
    int cap = g_serve_cap.load(std::memory_order_relaxed);
    bool counted = false;
    if (cap > 0) {
      std::string idkey(reinterpret_cast<const char*>(id), kIdLen);
      std::lock_guard<std::mutex> lk(g_serve_mu);
      int& n = g_active_by_id[idkey];
      if (n < cap) {
        ++n;
        counted = true;
      }
    }
    if (cap > 0 && !counted) {
      g_busy_rejections.fetch_add(1);
      ts_release(store, id);
      uint64_t busy = kBusy;
      if (!write_exact(fd, &busy, sizeof(busy))) break;
      continue;
    }
    const uint8_t* payload =
        reinterpret_cast<const uint8_t*>(ts_seg_base(store)) + off;
    bool ok = write_exact(fd, &size, sizeof(size)) &&
              write_exact(fd, payload, size);
    if (counted) {
      std::string idkey(reinterpret_cast<const char*>(id), kIdLen);
      std::lock_guard<std::mutex> lk(g_serve_mu);
      auto it = g_active_by_id.find(idkey);
      if (it != g_active_by_id.end() && --it->second <= 0)
        g_active_by_id.erase(it);
    }
    ts_release(store, id);
    if (!ok) break;
  }
}

// Thread body for one accepted connection: run the handler, then
// deregister BEFORE closing the fd — serve_stop shuts down registered
// fds under g_conn_mu, so the fd number can never be recycled while
// still in the registry.
void conn_main(int fd, void* store) {
  handle_conn(fd, store);
  {
    // notify INSIDE the critical section: once a waiter observes
    // g_live_threads == 0 under the mutex, this thread is provably past
    // its last cv touch — the process may exit and destroy the cv
    // without racing the broadcast. (The fd stays ours until close(), so
    // its number cannot be recycled into the registry meanwhile.)
    std::lock_guard<std::mutex> g(g_conn_mu);
    g_conn_fds.erase(std::find(g_conn_fds.begin(), g_conn_fds.end(), fd));
    g_live_threads--;
    g_conn_cv.notify_all();
  }
  close(fd);
}

}  // namespace

extern "C" {

// Start the transfer server on host:port (port 0 = ephemeral). Returns
// the bound port, or -1. One server per process.
int ts_xfer_serve_start(void* store, const char* host, int port) {
  if (g_server.listen_fd >= 0) return -1;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(fd);
    return -1;
  }
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 || listen(fd, 64) != 0) {
    close(fd);
    return -1;
  }
  socklen_t len = sizeof(addr);
  if (getsockname(fd, (sockaddr*)&addr, &len) != 0) {
    close(fd);
    return -1;
  }
  g_server.listen_fd = fd;
  g_server.store = store;
  g_server.stop.store(false);
  uint64_t gen = g_server.generation.fetch_add(1) + 1;

  {
    std::lock_guard<std::mutex> g(g_conn_mu);
    g_live_threads++;  // the listener itself
  }
  std::thread([fd, store, gen]() {
    while (!g_server.stop.load() && g_server.generation.load() == gen) {
      int conn = accept(fd, nullptr, nullptr);
      if (conn < 0) {
        if (g_server.stop.load() || g_server.generation.load() != gen)
          break;                        // stale thread after stop/restart
        if (errno == EINTR || errno == ECONNABORTED) continue;
        if (errno == EBADF || errno == EINVAL) break;  // fd closed
        usleep(10000);                  // EMFILE etc.: back off, don't spin
      } else {
        // Register under the lock, re-checking stop/generation there:
        // serve_stop iterates the registry under the same lock, so a
        // handler can neither be spawned after the drain snapshot nor
        // missed by it. (The stale-generation case also lands here: a
        // stale thread that won accept() on a REUSED fd number holds a
        // connection meant for the new server — drop it, the client
        // retries and lands on the live listener.)
        std::lock_guard<std::mutex> g(g_conn_mu);
        if (g_server.stop.load() || g_server.generation.load() != gen) {
          close(conn);
          break;
        }
        g_conn_fds.push_back(conn);
        g_live_threads++;
        std::thread(conn_main, conn, store).detach();
      }
    }
    {
      std::lock_guard<std::mutex> g(g_conn_mu);
      g_live_threads--;
      g_conn_cv.notify_all();  // inside the lock: see conn_main
    }
  }).detach();
  return (int)ntohs(addr.sin_port);
}

// Stop the server and drain every live handler thread. Returns the
// number of threads still live after the drain window — 0 means fully
// drained and the caller may munmap/detach the store; nonzero means a
// handler is wedged (e.g. blocked on the robust store mutex held by a
// crashed peer) and the caller MUST NOT unmap the segment or detach the
// handle, or the wedged thread's next touch is the round-3 SIGSEGV.
int ts_xfer_serve_stop() {
  if (g_server.listen_fd < 0) return 0;
  g_server.stop.store(true);
  g_server.generation.fetch_add(1);  // invalidate the listener thread
  // shutdown unblocks accept() reliably; close alone may not
  shutdown(g_server.listen_fd, SHUT_RDWR);
  close(g_server.listen_fd);
  g_server.listen_fd = -1;
  // Drain: shutdown() aborts any blocked socket read()/write()
  // immediately, and the registry empties as the threads deregister.
  std::unique_lock<std::mutex> lk(g_conn_mu);
  for (int cfd : g_conn_fds) shutdown(cfd, SHUT_RDWR);
  g_conn_cv.wait_for(lk, std::chrono::seconds(10),
                     [] { return g_live_threads == 0; });
  return g_live_threads;
}

// Fetch one object from a remote transfer server into the local store.
// Returns 0 = ok (sealed locally), 1 = absent at source, 2 = connect/io
// error, 3 = local allocation failed (caller should free space + retry
// or fall back), 4 = protocol error (local buffer aborted),
// 5 = already local (sealed, or a racing pull is mid-write — wait, do
// not free space for it), 6 = source at its serve cap (retry, ideally
// against another holder).
int ts_xfer_fetch(void* store, const char* host, int port,
                  const uint8_t* id, uint64_t* total_out) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return 2;
  set_timeouts(fd);
  sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1 ||
      connect(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    close(fd);
    return 2;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));

  uint64_t total = 0;
  if (!write_exact(fd, id, kIdLen) ||
      !read_exact(fd, &total, sizeof(total))) {
    close(fd);
    return 2;
  }
  if (total == kAbsent) {
    close(fd);
    return 1;
  }
  if (total == kBusy) {
    close(fd);
    return 6;
  }
  if (total_out) *total_out = total;
  uint64_t off = ts_create_buf(store, id, total);
  if (off == 0) {
    close(fd);
    // distinguish "already here / arriving" from a real OOM — a caller
    // reacting to OOM with a spill pass must not evict the store because
    // a concurrent duplicate pull won the create race
    return ts_state(store, id) != 0 ? 5 : 3;
  }
  uint8_t* dst = reinterpret_cast<uint8_t*>(ts_seg_base(store)) + off;
  // Receive with a heartbeat per read() batch (at most once a second),
  // NOT per 64 MiB chunk: a trickling sender can keep one chunk in
  // flight far past the orphan-reaper age (SO_RCVTIMEO bounds each
  // read(), not the chunk), and the reaper would free — and possibly
  // reallocate — the buffer while this loop is still writing into it.
  // With ≤1 s touch granularity a live socket can never age out; a
  // fully stalled socket times out in read() and aborts cleanly.
  uint64_t got = 0;
  uint64_t last_touch = (uint64_t)time(nullptr);
  while (got < total) {
    uint64_t want = total - got;
    if (want > (8ULL << 20)) want = (8ULL << 20);
    ssize_t r = read(fd, dst + got, want);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) {
      ts_abort(store, id);
      close(fd);
      return 4;
    }
    got += (uint64_t)r;
    uint64_t now = (uint64_t)time(nullptr);
    if (now != last_touch) {
      last_touch = now;
      if (ts_touch_creating(store, id) != 0) {
        // entry vanished mid-fetch (reaped after a stall, or deleted):
        // the buffer may already be reallocated — stop writing
        // IMMEDIATELY and DO NOT seal a foreign entry
        close(fd);
        return 4;
      }
    }
  }
  close(fd);
  ts_seal(store, id);
  return 0;
}

// Concurrent-outbound-serve cap PER OBJECT for this process's transfer
// server (0 = unlimited). Over-cap requests are answered kBusy.
void ts_xfer_set_serve_cap(int cap) {
  g_serve_cap.store(cap < 0 ? 0 : cap);
}

uint64_t ts_xfer_busy_rejections() { return g_busy_rejections.load(); }

}  // extern "C"
