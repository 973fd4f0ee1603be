// Shared-memory SPSC ring buffer — the native transport core of the
// multiprocess DataLoader (reference: paddle/fluid/memory/allocation/
// mmap_allocator.cc + python/paddle/io/dataloader's shared-memory path;
// the reference moves batches between loader workers and the trainer via
// mmap'd segments instead of pickling through pipes).
//
// Design: one ring per worker, single-producer (worker) single-consumer
// (trainer). Lock-free via C11 atomics on head/tail; messages are
// [u64 length][payload] records laid out as a pure byte stream modulo the
// capacity (reads/writes split across the edge with two memcpys), so any
// message up to capacity-8 bytes fits regardless of cursor position.
// Blocking push/pop use a bounded exponential nanosleep backoff (this host
// is single-core: spinning would starve the peer).
//
// Built at import time by csrc/__init__.py with g++ -O2 -shared -fPIC and
// bound via ctypes (no pybind11 in this image).
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct RingHeader {
  uint64_t capacity;             // data bytes (excl. header)
  std::atomic<uint64_t> head;    // write cursor (monotonic)
  std::atomic<uint64_t> tail;    // read cursor (monotonic)
  std::atomic<uint32_t> closed;  // producer hung up
};

struct Ring {
  RingHeader* hdr;
  uint8_t* data;
  size_t map_len;
  char name[256];
};

uint64_t used(const RingHeader* h) {
  return h->head.load(std::memory_order_acquire) -
         h->tail.load(std::memory_order_acquire);
}

void backoff_sleep(unsigned iter) {
  // 50us .. 2ms exponential; single-core host => always yield the CPU
  long ns = 50000L << (iter < 6 ? iter : 6);
  if (ns > 2000000L) ns = 2000000L;
  timespec ts{0, ns};
  nanosleep(&ts, nullptr);
}

int64_t now_ms() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

}  // namespace

namespace {

// byte-stream helpers: cursor is monotonic, position = cursor mod capacity,
// ranges split across the edge with two memcpys
void ring_write(uint8_t* data, uint64_t cap, uint64_t cursor,
                const uint8_t* src, uint64_t n) {
  uint64_t p = cursor & (cap - 1);
  uint64_t first = n < cap - p ? n : cap - p;
  memcpy(data + p, src, first);
  if (n > first) memcpy(data, src + first, n - first);
}

void ring_read(const uint8_t* data, uint64_t cap, uint64_t cursor,
               uint8_t* dst, uint64_t n) {
  uint64_t p = cursor & (cap - 1);
  uint64_t first = n < cap - p ? n : cap - p;
  memcpy(dst, data + p, first);
  if (n > first) memcpy(dst + first, data, n - first);
}

}  // namespace

extern "C" {

// Create (producer=0 consumer side first) or open a ring. capacity must be
// a power of two. Returns an opaque handle or nullptr.
void* shm_ring_create(const char* name, uint64_t capacity) {
  if (capacity == 0 || (capacity & (capacity - 1)) != 0) return nullptr;
  int fd = shm_open(name, O_CREAT | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t len = sizeof(RingHeader) + capacity;
  if (ftruncate(fd, (off_t)len) != 0) { close(fd); return nullptr; }
  void* p = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return nullptr;
  Ring* r = new Ring;
  r->hdr = (RingHeader*)p;
  r->data = (uint8_t*)p + sizeof(RingHeader);
  r->map_len = len;
  strncpy(r->name, name, sizeof(r->name) - 1);
  r->name[sizeof(r->name) - 1] = 0;
  r->hdr->capacity = capacity;
  r->hdr->head.store(0, std::memory_order_relaxed);
  r->hdr->tail.store(0, std::memory_order_relaxed);
  r->hdr->closed.store(0, std::memory_order_relaxed);
  return r;
}

void* shm_ring_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* p = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                 MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return nullptr;
  Ring* r = new Ring;
  r->hdr = (RingHeader*)p;
  r->data = (uint8_t*)p + sizeof(RingHeader);
  r->map_len = (size_t)st.st_size;
  strncpy(r->name, name, sizeof(r->name) - 1);
  r->name[sizeof(r->name) - 1] = 0;
  return r;
}

// Push one record. Blocks until space or timeout. 0 ok, -1 timeout,
// -2 message larger than capacity.
int shm_ring_push(void* handle, const uint8_t* buf, uint64_t len,
                  int64_t timeout_ms) {
  Ring* r = (Ring*)handle;
  RingHeader* h = r->hdr;
  const uint64_t cap = h->capacity;
  const uint64_t need = 8 + len;
  if (need > cap) return -2;
  int64_t deadline = timeout_ms < 0 ? -1 : now_ms() + timeout_ms;
  unsigned iter = 0;
  for (;;) {
    if (cap - used(h) >= need) {
      uint64_t head = h->head.load(std::memory_order_relaxed);
      ring_write(r->data, cap, head, (const uint8_t*)&len, 8);
      ring_write(r->data, cap, head + 8, buf, len);
      h->head.store(head + need, std::memory_order_release);
      return 0;
    }
    if (deadline >= 0 && now_ms() > deadline) return -1;
    backoff_sleep(iter++);
  }
}

// Pop one record into out (max_len bytes). Returns payload length,
// -1 timeout, -2 buffer too small, -3 producer closed and ring empty.
int64_t shm_ring_pop(void* handle, uint8_t* out, uint64_t max_len,
                     int64_t timeout_ms) {
  Ring* r = (Ring*)handle;
  RingHeader* h = r->hdr;
  const uint64_t cap = h->capacity;
  int64_t deadline = timeout_ms < 0 ? -1 : now_ms() + timeout_ms;
  unsigned iter = 0;
  for (;;) {
    if (used(h) >= 8) {
      uint64_t tail = h->tail.load(std::memory_order_relaxed);
      uint64_t len;
      ring_read(r->data, cap, tail, (uint8_t*)&len, 8);
      if (len > max_len) return -2;
      ring_read(r->data, cap, tail + 8, out, len);
      h->tail.store(tail + 8 + len, std::memory_order_release);
      return (int64_t)len;
    }
    if (h->closed.load(std::memory_order_acquire)) return -3;
    if (deadline >= 0 && now_ms() > deadline) return -1;
    backoff_sleep(iter++);
  }
}

// Peek next record's length without consuming (for buffer sizing).
// -1 = empty.
int64_t shm_ring_peek_len(void* handle) {
  Ring* r = (Ring*)handle;
  RingHeader* h = r->hdr;
  if (used(h) < 8) return -1;
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  uint64_t len;
  ring_read(r->data, h->capacity, tail, (uint8_t*)&len, 8);
  return (int64_t)len;
}

void shm_ring_mark_closed(void* handle) {
  ((Ring*)handle)->hdr->closed.store(1, std::memory_order_release);
}

int shm_ring_is_closed(void* handle) {
  return (int)((Ring*)handle)->hdr->closed.load(std::memory_order_acquire);
}

uint64_t shm_ring_used(void* handle) { return used(((Ring*)handle)->hdr); }

void shm_ring_close(void* handle, int unlink_seg) {
  Ring* r = (Ring*)handle;
  if (unlink_seg) shm_unlink(r->name);
  munmap((void*)r->hdr, r->map_len);
  delete r;
}

}  // extern "C"
