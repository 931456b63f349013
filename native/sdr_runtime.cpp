// Native host-side streaming runtime for the JAX flexframe PHY.
//
// Role-equivalent to the GNU Radio runtime capabilities the reference leans
// on (SURVEY.md section 2.3): lock-free stream ring buffers between
// producer/consumer threads (gr buffer analog), typed message queues
// (PMT message-port analog), a threaded sample source that ingests a
// continuous stream into fixed-size device-ready chunks, and atomic
// observability counters. The device compute path stays in JAX/XLA; this layer
// owns the host side of the streaming contract: fixed-size chunking with
// overlap-carry reads (the "frame may straddle any chunk boundary" contract
// of flexframesync, lib/flex_rx_impl.cc:203-215), back-pressure, and
// IO-thread/device-thread decoupling.
//
// C ABI exported for ctypes (no pybind11 in this environment).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#if defined(__cpp_lib_hardware_interference_size)
static constexpr size_t kCacheLine = std::hardware_destructive_interference_size;
#else
static constexpr size_t kCacheLine = 64;
#endif

extern "C" {

// ---------------------------------------------------------------------------
// ring_buffer: lock-free single-producer/single-consumer byte ring with
// overlap-carry reads. Capacity is rounded up to a power of two.
// ---------------------------------------------------------------------------

struct RingBuffer {
  std::vector<uint8_t> data;
  size_t mask;
  alignas(kCacheLine) std::atomic<uint64_t> head{0};  // write position
  alignas(kCacheLine) std::atomic<uint64_t> tail{0};  // read position
  std::atomic<uint64_t> total_written{0};
  std::atomic<uint64_t> total_read{0};
  std::atomic<int> eof{0};
};

RingBuffer* ring_create(uint64_t capacity) {
  size_t cap = 1;
  while (cap < capacity) cap <<= 1;
  auto* rb = new RingBuffer();
  rb->data.resize(cap);
  rb->mask = cap - 1;
  return rb;
}

void ring_destroy(RingBuffer* rb) { delete rb; }

uint64_t ring_capacity(RingBuffer* rb) { return rb->mask + 1; }

uint64_t ring_readable(RingBuffer* rb) {
  return rb->head.load(std::memory_order_acquire) -
         rb->tail.load(std::memory_order_acquire);
}

uint64_t ring_writable(RingBuffer* rb) {
  return ring_capacity(rb) - ring_readable(rb);
}

void ring_set_eof(RingBuffer* rb) { rb->eof.store(1, std::memory_order_release); }
int ring_eof(RingBuffer* rb) { return rb->eof.load(std::memory_order_acquire); }

// returns bytes written (may be < n when full: partial write)
uint64_t ring_write(RingBuffer* rb, const uint8_t* src, uint64_t n) {
  uint64_t head = rb->head.load(std::memory_order_relaxed);
  uint64_t avail = ring_capacity(rb) -
                   (head - rb->tail.load(std::memory_order_acquire));
  if (n > avail) n = avail;
  size_t cap = rb->mask + 1;
  size_t off = head & rb->mask;
  size_t first = std::min<uint64_t>(n, cap - off);
  std::memcpy(rb->data.data() + off, src, first);
  std::memcpy(rb->data.data(), src + first, n - first);
  rb->head.store(head + n, std::memory_order_release);
  rb->total_written.fetch_add(n, std::memory_order_relaxed);
  return n;
}

// Read exactly n bytes into dst, then rewind the read position by
// `overlap` bytes (the carry the next chunk re-reads — the frame-straddle
// contract). Returns n on success, 0 if fewer than n bytes are available.
uint64_t ring_read_overlap(RingBuffer* rb, uint8_t* dst, uint64_t n,
                           uint64_t overlap) {
  if (overlap >= n) return 0;
  uint64_t tail = rb->tail.load(std::memory_order_relaxed);
  uint64_t avail = rb->head.load(std::memory_order_acquire) - tail;
  if (avail < n) return 0;
  size_t cap = rb->mask + 1;
  size_t off = tail & rb->mask;
  size_t first = std::min<uint64_t>(n, cap - off);
  std::memcpy(dst, rb->data.data() + off, first);
  std::memcpy(dst + first, rb->data.data(), n - first);
  rb->tail.store(tail + (n - overlap), std::memory_order_release);
  rb->total_read.fetch_add(n - overlap, std::memory_order_relaxed);
  return n;
}

uint64_t ring_total_written(RingBuffer* rb) {
  return rb->total_written.load(std::memory_order_relaxed);
}
uint64_t ring_total_read(RingBuffer* rb) {
  return rb->total_read.load(std::memory_order_relaxed);
}

// ---------------------------------------------------------------------------
// msg_queue: bounded MPSC queue of opaque byte messages (PMT-port analog).
// ---------------------------------------------------------------------------

struct MsgQueue {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::vector<uint8_t>> q;
  size_t max_msgs;
  std::atomic<uint64_t> dropped{0};
};

MsgQueue* msgq_create(uint64_t max_msgs) {
  auto* mq = new MsgQueue();
  mq->max_msgs = max_msgs ? max_msgs : 1 << 20;
  return mq;
}
void msgq_destroy(MsgQueue* mq) { delete mq; }

// returns 1 on enqueue, 0 if full (message dropped, counted)
int msgq_put(MsgQueue* mq, const uint8_t* data, uint64_t n) {
  std::unique_lock<std::mutex> lk(mq->mu);
  if (mq->q.size() >= mq->max_msgs) {
    mq->dropped.fetch_add(1, std::memory_order_relaxed);
    return 0;
  }
  mq->q.emplace_back(data, data + n);
  lk.unlock();
  mq->cv.notify_one();
  return 1;
}

// returns message size (copied into dst up to dst_cap), 0 on timeout/empty,
// -1 if the message was larger than dst_cap (message is dropped)
int64_t msgq_get(MsgQueue* mq, uint8_t* dst, uint64_t dst_cap,
                 int64_t timeout_ms) {
  std::unique_lock<std::mutex> lk(mq->mu);
  if (mq->q.empty()) {
    if (timeout_ms <= 0) return 0;
    mq->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                    [&] { return !mq->q.empty(); });
    if (mq->q.empty()) return 0;
  }
  auto msg = std::move(mq->q.front());
  mq->q.pop_front();
  lk.unlock();
  if (msg.size() > dst_cap) return -1;
  std::memcpy(dst, msg.data(), msg.size());
  return static_cast<int64_t>(msg.size());
}

uint64_t msgq_size(MsgQueue* mq) {
  std::lock_guard<std::mutex> lk(mq->mu);
  return mq->q.size();
}
uint64_t msgq_dropped(MsgQueue* mq) {
  return mq->dropped.load(std::memory_order_relaxed);
}

// ---------------------------------------------------------------------------
// stream_source: a producer thread feeding a ring from a memory buffer at a
// target rate (samples/s; 0 = as fast as possible). Models a radio
// front-end / file source; the Python side reads device-ready chunks.
// ---------------------------------------------------------------------------

struct StreamSource {
  RingBuffer* ring;
  std::vector<uint8_t> src;
  uint64_t item_size;
  double rate;  // items per second; 0 = unthrottled
  int repeat;
  std::thread th;
  std::atomic<int> stop_flag{0};
};

static void source_main(StreamSource* s) {
  const uint64_t burst_items = 4096;
  uint64_t pos = 0;
  auto t0 = std::chrono::steady_clock::now();
  uint64_t sent_items = 0;
  while (!s->stop_flag.load(std::memory_order_acquire)) {
    if (pos >= s->src.size()) {
      if (!s->repeat) break;
      pos = 0;
    }
    uint64_t n = std::min<uint64_t>(burst_items * s->item_size,
                                    s->src.size() - pos);
    uint64_t w = ring_write(s->ring, s->src.data() + pos, n);
    pos += w;
    sent_items += w / s->item_size;
    if (w == 0) {
      std::this_thread::yield();
      continue;
    }
    if (s->rate > 0) {
      auto target = t0 + std::chrono::duration<double>(sent_items / s->rate);
      std::this_thread::sleep_until(target);
    }
  }
  ring_set_eof(s->ring);
}

StreamSource* source_create(RingBuffer* ring, const uint8_t* data,
                            uint64_t nbytes, uint64_t item_size, double rate,
                            int repeat) {
  auto* s = new StreamSource();
  s->ring = ring;
  s->src.assign(data, data + nbytes);
  s->item_size = item_size ? item_size : 1;
  s->rate = rate;
  s->repeat = repeat;
  s->th = std::thread(source_main, s);
  return s;
}

void source_stop(StreamSource* s) {
  s->stop_flag.store(1, std::memory_order_release);
  if (s->th.joinable()) s->th.join();
}

void source_destroy(StreamSource* s) {
  source_stop(s);
  delete s;
}

// ---------------------------------------------------------------------------
// counters: named atomic counters for per-stage observability
// ---------------------------------------------------------------------------

struct Counters {
  std::vector<std::atomic<uint64_t>> v;
  explicit Counters(size_t n) : v(n) {}
};

Counters* counters_create(uint64_t n) { return new Counters(n); }
void counters_destroy(Counters* c) { delete c; }
void counters_add(Counters* c, uint64_t idx, uint64_t delta) {
  if (idx < c->v.size()) c->v[idx].fetch_add(delta, std::memory_order_relaxed);
}
uint64_t counters_get(Counters* c, uint64_t idx) {
  return idx < c->v.size() ? c->v[idx].load(std::memory_order_relaxed) : 0;
}

}  // extern "C"
