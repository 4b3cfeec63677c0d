// The train step's zero-valid gate as two copies over a table of byte ranges,
// sm_90a.
//
// gate_snapshot: every range of the table (the gated tensors' memory: the
// parameters, the BatchNorm buffers, AdamW's moments and step counts, any
// dtype) copied into one flat buffer, each range into its own slot.
// gate_restore: the same ranges copied back from their slots when the step's
// valid count (a float32 on the device) is not > 0, which is the step's former
// torch.where(valid_count > 0, live, old) per tensor, NaN included; otherwise
// every block returns at once. A restoring launch raises the int64 counter
// `restores` by one (one thread of block 0).
//
// It replaces no Pallas kernel: the JAX package selects old or new state with
// jax.tree.map(keep_if_valid, ...) in its train step
// (stereo_depth_estimation_tpu/parallel/train_step.py:205-216), which XLA fuses
// into the step's program. The port's eager step ran a clone, a where and a
// copy_ per gated tensor instead: 954 launches a step on the StereoUNet, about
// 3,900 on PSMNet. These are two launches a step.
//
// What bounds them: memory. A snapshot reads and writes every gated byte once.
// The StereoUNet's 7,763,938 float32 weights and AdamW's two moments are 93.2
// MB, so 186 MB moved, 55.6 us at 3.35 TB/s; PSMNet's 5,224,768 are 62.7 MB,
// 37.4 us. A restore at a batch with valid pixels reads one float a block; one
// that restores moves as much as the snapshot.
//
// What the design does about it: the table is built once on the host
// (ops/gate.py) and read from device memory. Each range's bytes sit in a slot
// that starts 16-byte aligned, shifted by the range's own address mod 16, so
// both ends of every byte agree mod 16: the body of a range moves as 16-byte
// words, loaded and stored, and only its unaligned head and tail (under 16
// bytes each) move a byte a thread. The slots are cut into fixed chunks, and
// the table lists the range of every chunk, as multi-tensor apply lists its
// blocks, so a 0-dim count and a 4.7M-element moment spread over the SMs
// alike. A grid of a few blocks an SM strides over the chunks, each thread
// keeping four 16-byte loads in flight. Offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte words in flight a thread
constexpr int64_t kStride = int64_t{16} * kThreads * kUnroll;

// The device table: five int64 arrays, one after the other. Range r starts
// at address live[r], holds bytes[r] bytes, and its slot starts slot[r]
// bytes into the buffer (a multiple of 16); its chunks are first[r] onwards.
// Chunk c belongs to range range_of[c].
struct Table {
  const int64_t* live;
  const int64_t* bytes;
  const int64_t* slot;
  const int64_t* first;
  const int64_t* range_of;
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) { return a > b ? a : b; }

// Chunk c between its range and the range's slot: into the slot, or back
// (Restore). Slot byte j holds the range's byte j - mis, where mis is the
// range's address mod 16; the chunk covers slot bytes [k chunk, (k + 1)
// chunk) of the range's [mis, mis + bytes).
template <bool Restore>
__device__ __forceinline__ void copy_chunk(const Table& table, int64_t c, int64_t chunk,
                                           char* buffer) {
  const int64_t r = table.range_of[c];
  const int64_t live = table.live[r];
  const int64_t mis = live & 15;
  char* const live_base = reinterpret_cast<char*>(live - mis);  // 16-byte aligned
  char* const slot_base = buffer + table.slot[r];               // 16-byte aligned
  const int64_t k = c - table.first[r];
  const int64_t lo = lmax(k * chunk, mis);
  const int64_t hi = lmin((k + 1) * chunk, mis + table.bytes[r]);
  // 16-byte words over [body_lo, body_hi); bytes over [lo, body_lo) and
  // [body_hi, hi), each under 16.
  const int64_t body_lo = lmin((lo + 15) & ~int64_t{15}, hi);
  const int64_t body_hi = lmax(hi & ~int64_t{15}, body_lo);
  const char* const src = Restore ? slot_base : live_base;
  char* const dst = Restore ? live_base : slot_base;
  const int t = threadIdx.x;
  if (t < body_lo - lo) dst[lo + t] = src[lo + t];
  if (t < hi - body_hi) dst[body_hi + t] = src[body_hi + t];
  for (int64_t j = body_lo + int64_t{16} * t; j < body_hi; j += kStride) {
    uint4 word[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t at = j + int64_t{16} * kThreads * u;
      if (at < body_hi) word[u] = *reinterpret_cast<const uint4*>(src + at);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t at = j + int64_t{16} * kThreads * u;
      if (at < body_hi) *reinterpret_cast<uint4*>(dst + at) = word[u];
    }
  }
}

template <bool Restore>
__global__ void __launch_bounds__(kThreads)
gate_kernel(const int64_t* __restrict__ table, int64_t ranges, int64_t chunks, int64_t chunk,
            char* buffer, const float* __restrict__ valid_count, int64_t* restores) {
  if constexpr (Restore) {
    if (*valid_count > 0.0f) return;  // NaN > 0 is false: NaN restores
    if (blockIdx.x == 0 && threadIdx.x == 0) *restores += 1;
  }
  const Table t{table, table + ranges, table + 2 * ranges, table + 3 * ranges,
                table + 4 * ranges};
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    copy_chunk<Restore>(t, c, chunk, buffer);
  }
}

bool valid_launch(int64_t ranges, int64_t chunks, int64_t chunk, int grid) {
  return ranges > 0 && chunks >= ranges && chunk > 0 && chunk % 16 == 0 && grid > 0;
}

}  // namespace

extern "C" {

const char* gate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table: the device table above (4 ranges + chunks int64s); buffer: the
// slots, 16-byte aligned. Launches `grid` blocks on `stream` and returns
// cudaGetLastError().
int gate_snapshot(const int64_t* table, int64_t ranges, int64_t chunks, int64_t chunk,
                  void* buffer, int grid, void* stream) {
  if (!valid_launch(ranges, chunks, chunk, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gate_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, ranges, chunks, chunk, static_cast<char*>(buffer), nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// As gate_snapshot, back from the slots when !(*valid_count > 0), raising
// *restores by one; else nothing.
int gate_restore(const int64_t* table, int64_t ranges, int64_t chunks, int64_t chunk,
                 void* buffer, const float* valid_count, int64_t* restores, int grid,
                 void* stream) {
  if (!valid_launch(ranges, chunks, chunk, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gate_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, ranges, chunks, chunk, static_cast<char*>(buffer), valid_count, restores);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
