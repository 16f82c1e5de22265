// The host instance ring: a ring of reusable host buffers that hands the
// 64 B/particle instance records (`ParticleInstance`, reference
// render.rs:95-115) from the simulation to the renderer, latest frame
// first, as Bevy's pipelined extract hands its copy (render.rs:52-54).
//
//   1. owns n_slots host buffers of `capacity` records (no per-frame
//      allocation),
//   2. interleaves planar arrays (one per record column, the device's
//      layout) into records, compacting the live lanes of dense planes
//      (scale == 0 marks a dead lane) as it goes; f32 or f16 records,
//   3. hands slots between a producer (the reader thread) and a consumer
//      (the render thread) with atomic publish / acquire, no locks: a
//      producer that finds every slot busy takes the oldest ready one, so a
//      slow consumer skips frames and never blocks the simulation.
//
// A copy of bevy_firework_tpu/native/instance_ring.cpp (same C interface).
// Built by bevy_firework_tpu_torch/native/__init__.py at first use:
// g++ -O3 -std=c++17 -shared -fPIC.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int kFloatsPerInstance = 16;  // 64 bytes

struct Slot {
  float* data = nullptr;        // interleaved [capacity, 16]
  int64_t count = 0;            // live instances in this slot
  int64_t frame_id = -1;        // producer frame stamp
  std::atomic<int> state{0};    // 0 free, 1 writing, 2 ready, 3 reading
};

struct Ring {
  int64_t capacity = 0;  // max instances per slot
  int n_slots = 0;
  Slot* slots = nullptr;
  std::atomic<int64_t> latest_frame{-1};
};

}  // namespace

extern "C" {

void* ring_create(int64_t capacity, int n_slots) {
  Ring* r = new Ring();
  r->capacity = capacity;
  r->n_slots = n_slots;
  r->slots = new Slot[n_slots];
  for (int i = 0; i < n_slots; ++i) {
    // 64-byte aligned for cacheline-friendly DMA/upload
    r->slots[i].data = static_cast<float*>(
        aligned_alloc(64, static_cast<size_t>(capacity) * kFloatsPerInstance * sizeof(float)));
  }
  return r;
}

void ring_destroy(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  for (int i = 0; i < r->n_slots; ++i) free(r->slots[i].data);
  delete[] r->slots;
  delete r;
}

int64_t ring_capacity(void* handle) { return static_cast<Ring*>(handle)->capacity; }

// Producer: claim a free slot for writing. Returns slot index or -1.
int ring_begin_write(void* handle) {
  Ring* r = static_cast<Ring*>(handle);
  for (int i = 0; i < r->n_slots; ++i) {
    int expected = 0;
    if (r->slots[i].state.compare_exchange_strong(expected, 1)) return i;
  }
  // all busy: steal the oldest ready slot (renderer is behind; drop frames,
  // matching the pipelined-extract semantics of only rendering the latest)
  for (int i = 0; i < r->n_slots; ++i) {
    int expected = 2;
    if (r->slots[i].state.compare_exchange_strong(expected, 1)) return i;
  }
  return -1;
}

float* ring_slot_data(void* handle, int slot) {
  return static_cast<Ring*>(handle)->slots[slot].data;
}

// Producer: fill `slot` from 16 planar arrays and publish.
// planes: pointer to 16 contiguous arrays each of length `count`
// (i.e. planes[p * plane_stride + i] is component p of instance i).
void ring_publish_planar(void* handle, int slot, const float* planes,
                         int64_t plane_stride, int64_t count, int64_t frame_id) {
  Ring* r = static_cast<Ring*>(handle);
  Slot& s = r->slots[slot];
  if (count > r->capacity) count = r->capacity;
  float* dst = s.data;
  // 16-plane interleave; inner loop over instances autovectorizes per plane.
  for (int p = 0; p < kFloatsPerInstance; ++p) {
    const float* src = planes + p * plane_stride;
    float* d = dst + p;
    for (int64_t i = 0; i < count; ++i) {
      d[i * kFloatsPerInstance] = src[i];
    }
  }
  s.count = count;
  s.frame_id = frame_id;
  s.state.store(2, std::memory_order_release);
  r->latest_frame.store(frame_id, std::memory_order_release);
}

// Producer: publish pre-interleaved rows (memcpy path).
void ring_publish_rows(void* handle, int slot, const float* rows, int64_t count,
                       int64_t frame_id) {
  Ring* r = static_cast<Ring*>(handle);
  Slot& s = r->slots[slot];
  if (count > r->capacity) count = r->capacity;
  std::memcpy(s.data, rows, static_cast<size_t>(count) * kFloatsPerInstance * sizeof(float));
  s.count = count;
  s.frame_id = frame_id;
  s.state.store(2, std::memory_order_release);
  r->latest_frame.store(frame_id, std::memory_order_release);
}

// Consumer: acquire the newest ready slot (or -1). Marks it reading.
int ring_acquire(void* handle, int64_t* out_count, int64_t* out_frame) {
  Ring* r = static_cast<Ring*>(handle);
  int best = -1;
  int64_t best_frame = -1;
  for (int i = 0; i < r->n_slots; ++i) {
    if (r->slots[i].state.load(std::memory_order_acquire) == 2 &&
        r->slots[i].frame_id > best_frame) {
      best = i;
      best_frame = r->slots[i].frame_id;
    }
  }
  if (best < 0) return -1;
  int expected = 2;
  if (!r->slots[best].state.compare_exchange_strong(expected, 3)) return -1;
  *out_count = r->slots[best].count;
  *out_frame = r->slots[best].frame_id;
  return best;
}

// Consumer: release a slot back to the free pool.
void ring_release(void* handle, int slot) {
  static_cast<Ring*>(handle)->slots[slot].state.store(0, std::memory_order_release);
}

// Standalone planar -> interleaved transpose (no ring).
void transpose_planes(float* dst, const float* planes, int64_t plane_stride, int64_t count) {
  for (int p = 0; p < kFloatsPerInstance; ++p) {
    const float* src = planes + p * plane_stride;
    float* d = dst + p;
    for (int64_t i = 0; i < count; ++i) {
      d[i * kFloatsPerInstance] = src[i];
    }
  }
}

// Standalone dense-plane compaction (no ring): interleave live lanes
// (plane 3 = scale != 0) of [16, n_lanes] planes into dst rows [*, 16].
// Returns the live count. The synchronous Scene.render_items() fast path.
int64_t compact_dense(float* dst, const float* planes, int64_t plane_stride,
                      int64_t n_lanes) {
  const float* scale = planes + 3 * plane_stride;
  int64_t count = 0;
  for (int64_t i = 0; i < n_lanes; ++i) {
    if (scale[i] == 0.0f) continue;
    float* d = dst + count * kFloatsPerInstance;
    for (int p = 0; p < kFloatsPerInstance; ++p) {
      d[p] = planes[p * plane_stride + i];
    }
    ++count;
  }
  return count;
}

// Compaction from 16 SEPARATE plane arrays (the in-kernel render pack emits
// scale/color planes as individual device arrays; positions/rotations come
// from pool state arrays). planes[p] == nullptr means the component is a
// pool-wide invariant: defaults[p] is used (e.g. identity rotation under
// rotation elision — those planes are then never even transferred).
// plane 3 (scale) must be non-null; scale == 0 marks dead lanes.
int64_t compact_dense_ptrs(float* dst, const float* const* planes,
                           const float* defaults, int64_t n_lanes) {
  const float* scale = planes[3];
  int64_t count = 0;
  for (int64_t i = 0; i < n_lanes; ++i) {
    if (scale[i] == 0.0f) continue;
    float* d = dst + count * kFloatsPerInstance;
    for (int p = 0; p < kFloatsPerInstance; ++p) {
      d[p] = planes[p] ? planes[p][i] : defaults[p];
    }
    ++count;
  }
  return count;
}

// Producer: fill `slot` from DENSE planes (every pool lane, dead lanes have
// scale == 0 in plane 3), compacting live lanes while interleaving.  This is
// the production extract path: the device emits dense planes for free (the
// pack fuses into the step kernel); the host-side compaction happens here,
// overlapped with the next frame's device compute. Returns the live count.
int64_t ring_publish_dense(void* handle, int slot, const float* planes,
                           int64_t plane_stride, int64_t n_lanes, int64_t frame_id) {
  Ring* r = static_cast<Ring*>(handle);
  Slot& s = r->slots[slot];
  const float* scale = planes + 3 * plane_stride;
  float* dst = s.data;
  int64_t count = 0;
  for (int64_t i = 0; i < n_lanes; ++i) {
    if (scale[i] == 0.0f) continue;
    if (count >= r->capacity) break;
    float* d = dst + count * kFloatsPerInstance;
    for (int p = 0; p < kFloatsPerInstance; ++p) {
      d[p] = planes[p * plane_stride + i];
    }
    ++count;
  }
  s.count = count;
  s.frame_id = frame_id;
  s.state.store(2, std::memory_order_release);
  r->latest_frame.store(frame_id, std::memory_order_release);
  return count;
}

// ring_publish_dense from 16 SEPARATE plane arrays (see compact_dense_ptrs):
// the in-kernel render pack hands scale/colors as individual device arrays
// and positions/rotations as pool-state arrays; nullptr planes use
// defaults[p] (elided invariants, e.g. identity rotation). Compacts live
// lanes (plane 3 scale != 0) into the slot and publishes.
int64_t ring_publish_dense_ptrs(void* handle, int slot, const float* const* planes,
                                const float* defaults, int64_t n_lanes,
                                int64_t frame_id) {
  Ring* r = static_cast<Ring*>(handle);
  Slot& s = r->slots[slot];
  const float* scale = planes[3];
  float* dst = s.data;
  int64_t count = 0;
  for (int64_t i = 0; i < n_lanes; ++i) {
    if (scale[i] == 0.0f) continue;
    if (count >= r->capacity) break;
    float* d = dst + count * kFloatsPerInstance;
    for (int p = 0; p < kFloatsPerInstance; ++p) {
      d[p] = planes[p] ? planes[p][i] : defaults[p];
    }
    ++count;
  }
  s.count = count;
  s.frame_id = frame_id;
  s.state.store(2, std::memory_order_release);
  r->latest_frame.store(frame_id, std::memory_order_release);
  return count;
}

// f16 variant of ring_publish_dense_ptrs: 16 separate uint16-encoded f16
// plane arrays (nullptr => defaults[p]); slot holds f16 rows (32 B/
// particle). scale bits 0x0000/0x8000 mark dead lanes.
int64_t ring_publish_dense_ptrs_f16(void* handle, int slot,
                                    const uint16_t* const* planes,
                                    const uint16_t* defaults, int64_t n_lanes,
                                    int64_t frame_id) {
  Ring* r = static_cast<Ring*>(handle);
  Slot& s = r->slots[slot];
  const uint16_t* scale = planes[3];
  uint16_t* dst = reinterpret_cast<uint16_t*>(s.data);
  int64_t count = 0;
  for (int64_t i = 0; i < n_lanes; ++i) {
    uint16_t sc = scale[i];
    if (sc == 0 || sc == 0x8000) continue;
    if (count >= r->capacity) break;
    uint16_t* d = dst + count * kFloatsPerInstance;
    for (int p = 0; p < kFloatsPerInstance; ++p) {
      d[p] = planes[p] ? planes[p][i] : defaults[p];
    }
    ++count;
  }
  s.count = count;
  s.frame_id = frame_id;
  s.state.store(2, std::memory_order_release);
  r->latest_frame.store(frame_id, std::memory_order_release);
  return count;
}

// f16 variant of ring_publish_dense: planes are uint16-encoded IEEE float16
// (32 B/particle after interleave — halves device->host render bandwidth).
// The slot buffer is reinterpreted as uint16; scale==0 (bits 0x0000/0x8000)
// marks dead lanes.
int64_t ring_publish_dense_f16(void* handle, int slot, const uint16_t* planes,
                               int64_t plane_stride, int64_t n_lanes, int64_t frame_id) {
  Ring* r = static_cast<Ring*>(handle);
  Slot& s = r->slots[slot];
  const uint16_t* scale = planes + 3 * plane_stride;
  uint16_t* dst = reinterpret_cast<uint16_t*>(s.data);
  int64_t count = 0;
  for (int64_t i = 0; i < n_lanes; ++i) {
    uint16_t sc = scale[i];
    if (sc == 0 || sc == 0x8000) continue;  // +-0.0 in f16
    if (count >= r->capacity) break;
    uint16_t* d = dst + count * kFloatsPerInstance;
    for (int p = 0; p < kFloatsPerInstance; ++p) {
      d[p] = planes[p * plane_stride + i];
    }
    ++count;
  }
  s.count = count;
  s.frame_id = frame_id;
  s.state.store(2, std::memory_order_release);
  r->latest_frame.store(frame_id, std::memory_order_release);
  return count;
}

}  // extern "C"
