// vectorwave_tpu native ingest runtime: lock-free SPSC ring buffer with an
// overlapping frame assembler.
//
// Role (cf. /root/reference/vectorwave-core/.../modwt/streaming/
// MODWTStreamingTransformImpl.java:45-120 and the Flow.Publisher plumbing in
// MultiLevelMODWTStreamingTransform.java): the reference ingests ticks on a
// JVM thread, keeps a circular buffer with an overlap of filterLength-1
// samples, and emits full windows downstream.  Here the host-side half of
// that pipeline is native C++ so a producer thread can feed samples at
// sub-microsecond cost while the consumer assembles device-ready overlapping
// frames ([n_frames, frame_len] batches) for the jitted sliding-window MODWT
// (streaming/sliding.py).  The accelerator never sees this code - it is pure host
// runtime, which is exactly where native code belongs in a JAX framework.
//
// Design:
//   * single-producer / single-consumer, wait-free on both sides:
//     - `tail_` (write cursor) is owned by the producer, `head_` (read
//       cursor) by the consumer; both are monotonically increasing tick
//       counts published with release stores and read with acquire loads.
//   * a "tick" is one multi-channel sample: `channels * itemsize` bytes,
//     stored interleaved.  Frames come out as [frame_len, channels] blocks.
//   * frame pops consume `hop` ticks per frame and leave the remaining
//     `frame_len - hop` ticks as overlap - the exact contract of
//     streaming/sliding.py (hop = buffer_size - overlap).
//   * full buffer rejects new ticks (bounded memory, like the reference's
//     100 MB cap) and counts them in `dropped_`.
//
// Built at first import by vectorwave_tpu/native/__init__.py (g++ -O3); a
// pure-NumPy fallback with identical semantics covers compilerless hosts.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

namespace {

constexpr size_t kCacheLine = 64;

struct RingBuffer {
  // immutable after construction
  uint64_t capacity;   // ticks
  uint32_t channels;
  uint32_t itemsize;   // bytes per scalar (4 or 8)
  uint64_t tick_bytes; // channels * itemsize
  char *data;

  // producer-owned cursor (ticks written), consumer reads it with acquire.
  alignas(kCacheLine) std::atomic<uint64_t> tail;
  alignas(kCacheLine) std::atomic<uint64_t> dropped;
  // consumer-owned cursor (ticks consumed), producer reads it with acquire.
  alignas(kCacheLine) std::atomic<uint64_t> head;
};

// Copy `nticks` ticks starting at absolute tick index `pos` out of the ring
// into `dst` (handles the wrap with at most two memcpys).
inline void copy_out(const RingBuffer *rb, uint64_t pos, uint64_t nticks,
                     char *dst) {
  const uint64_t start = pos % rb->capacity;
  const uint64_t first = (start + nticks <= rb->capacity)
                             ? nticks
                             : rb->capacity - start;
  std::memcpy(dst, rb->data + start * rb->tick_bytes,
              first * rb->tick_bytes);
  if (first < nticks) {
    std::memcpy(dst + first * rb->tick_bytes, rb->data,
                (nticks - first) * rb->tick_bytes);
  }
}

inline void copy_in(RingBuffer *rb, uint64_t pos, uint64_t nticks,
                    const char *src) {
  const uint64_t start = pos % rb->capacity;
  const uint64_t first = (start + nticks <= rb->capacity)
                             ? nticks
                             : rb->capacity - start;
  std::memcpy(rb->data + start * rb->tick_bytes, src,
              first * rb->tick_bytes);
  if (first < nticks) {
    std::memcpy(rb->data, src + first * rb->tick_bytes,
                (nticks - first) * rb->tick_bytes);
  }
}

} // namespace

extern "C" {

void *vw_rb_create(uint64_t capacity_ticks, uint32_t channels,
                   uint32_t itemsize) {
  if (capacity_ticks == 0 || channels == 0 ||
      (itemsize != 4 && itemsize != 8)) {
    return nullptr;
  }
  auto *rb = new (std::nothrow) RingBuffer();
  if (rb == nullptr) return nullptr;
  rb->capacity = capacity_ticks;
  rb->channels = channels;
  rb->itemsize = itemsize;
  rb->tick_bytes = static_cast<uint64_t>(channels) * itemsize;
  rb->data = static_cast<char *>(
      std::malloc(capacity_ticks * rb->tick_bytes));
  if (rb->data == nullptr) {
    delete rb;
    return nullptr;
  }
  rb->tail.store(0, std::memory_order_relaxed);
  rb->head.store(0, std::memory_order_relaxed);
  rb->dropped.store(0, std::memory_order_relaxed);
  return rb;
}

void vw_rb_destroy(void *h) {
  if (h == nullptr) return;
  auto *rb = static_cast<RingBuffer *>(h);
  std::free(rb->data);
  delete rb;
}

uint64_t vw_rb_capacity(void *h) {
  return static_cast<RingBuffer *>(h)->capacity;
}

// Ticks currently readable by the consumer.
uint64_t vw_rb_available(void *h) {
  auto *rb = static_cast<RingBuffer *>(h);
  return rb->tail.load(std::memory_order_acquire) -
         rb->head.load(std::memory_order_acquire);
}

uint64_t vw_rb_dropped(void *h) {
  return static_cast<RingBuffer *>(h)->dropped.load(
      std::memory_order_acquire);
}

// Producer side: append up to `nticks` ticks from `src`; returns the number
// actually written (the rest are counted as dropped).
uint64_t vw_rb_push(void *h, const void *src, uint64_t nticks) {
  auto *rb = static_cast<RingBuffer *>(h);
  const uint64_t tail = rb->tail.load(std::memory_order_relaxed);
  const uint64_t head = rb->head.load(std::memory_order_acquire);
  const uint64_t free_ticks = rb->capacity - (tail - head);
  const uint64_t n = nticks < free_ticks ? nticks : free_ticks;
  if (n > 0) {
    copy_in(rb, tail, n, static_cast<const char *>(src));
    rb->tail.store(tail + n, std::memory_order_release);
  }
  if (n < nticks) {
    rb->dropped.fetch_add(nticks - n, std::memory_order_relaxed);
  }
  return n;
}

// Consumer side: plain pop of up to `nticks` ticks into `dst`.
uint64_t vw_rb_pop(void *h, void *dst, uint64_t nticks) {
  auto *rb = static_cast<RingBuffer *>(h);
  const uint64_t head = rb->head.load(std::memory_order_relaxed);
  const uint64_t tail = rb->tail.load(std::memory_order_acquire);
  const uint64_t avail = tail - head;
  const uint64_t n = nticks < avail ? nticks : avail;
  if (n > 0) {
    copy_out(rb, head, n, static_cast<char *>(dst));
    rb->head.store(head + n, std::memory_order_release);
  }
  return n;
}

// Consumer side: assemble up to `max_frames` overlapping frames of
// `frame_len` ticks, advancing by `hop` ticks per frame.  `dst` must hold
// max_frames * frame_len * channels * itemsize bytes; frames are written
// consecutively ([frame, time, channel] layout).  Returns frames written.
uint64_t vw_rb_pop_frames(void *h, void *dst, uint64_t frame_len,
                          uint64_t hop, uint64_t max_frames) {
  auto *rb = static_cast<RingBuffer *>(h);
  if (frame_len == 0 || hop == 0 || hop > frame_len ||
      frame_len > rb->capacity) {
    return 0;
  }
  uint64_t head = rb->head.load(std::memory_order_relaxed);
  const uint64_t tail = rb->tail.load(std::memory_order_acquire);
  const uint64_t avail = tail - head;
  if (avail < frame_len) return 0;
  uint64_t n_frames = 1 + (avail - frame_len) / hop;
  if (n_frames > max_frames) n_frames = max_frames;

  char *out = static_cast<char *>(dst);
  const uint64_t frame_bytes = frame_len * rb->tick_bytes;
  for (uint64_t f = 0; f < n_frames; ++f) {
    copy_out(rb, head + f * hop, frame_len, out + f * frame_bytes);
  }
  // consume hop per frame; the final frame's trailing overlap stays queued.
  rb->head.store(head + n_frames * hop, std::memory_order_release);
  return n_frames;
}

// Consumer side: copy the most recent `nticks` ticks without consuming
// (real-time monitors that want "latest window" semantics).
uint64_t vw_rb_peek_latest(void *h, void *dst, uint64_t nticks) {
  auto *rb = static_cast<RingBuffer *>(h);
  const uint64_t head = rb->head.load(std::memory_order_relaxed);
  const uint64_t tail = rb->tail.load(std::memory_order_acquire);
  const uint64_t avail = tail - head;
  const uint64_t n = nticks < avail ? nticks : avail;
  if (n > 0) {
    copy_out(rb, tail - n, n, static_cast<char *>(dst));
  }
  return n;
}

} // extern "C"
