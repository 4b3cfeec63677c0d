// 2x2/stride-2 max pool, forward with the first-max index and backward from
// that index, NHWC, sm_90a.
//
// maxpool2x2_fwd replaces the Pallas TPU kernel scripts/pool_lab.py:91
// (maxpool2x2_pallas_fwd; body _fwd_kernel :60): x (N, H, W, C) f32 or bf16
// -> y (N, H/2, W/2, C) in x's dtype and idx (N, H/2, W/2, C) uint8, where idx
// is the position of the FIRST maximum in window order (0,0), (0,1), (1,0),
// (1,1) (pool_lab's _max_and_first_idx, :48). A window that holds a NaN gives
// y = NaN, as jnp.maximum does, and idx = 3, because every ">=" against NaN is
// false.
// maxpool2x2_bwd replaces scripts/pool_lab.py:112 (maxpool2x2_pallas_bwd; body
// _bwd_kernel :74): dy (N, H/2, W/2, C) and idx -> dx (N, H, W, C), dy at the
// position idx names and exact 0 at the other three. Every element of dx is
// written, so dx needs no zero-fill pass.
//
// What bounds them: memory. Both move the same bytes: x (or dx) once, y (or
// dy) once and idx once. At the StereoUNet's first pool level (batch 128,
// 240x320, 32 channels, bf16) that is 629.1 + 157.3 + 78.6 = 865.1 MB, about
// 258 us at 3.35 TB/s; the four levels of one step move 1,622 MB in each
// direction, about 484 us. The arithmetic (three compares and a few selects
// per output) is negligible.
//
// What the design does about it: each byte is read or written once, in the
// NHWC layout the model's channels_last activations already have, so no
// transpose runs before or after; the index is one byte where PyTorch's
// max_pool2d_with_indices saves eight. A thread owns one output pixel and 16
// bytes of its channels (4 f32 or 8 bf16). It moves them as explicit 16-byte
// words (uint4), stored through __stwb so that the compiler cannot split
// them, so every load and store is one 128-bit access: four loads of
// the window rows' values, one store of y and one of the 4 or 8 index bytes
// (backward: two loads, four 16-byte stores); neighbouring threads touch
// neighbouring addresses. Values are handled as raw bits (a bf16 is the top
// half of an f32), so y is the selected input element itself and dx is dy's
// bits or +0. Where C does not divide into 16-byte groups, or a pointer is
// not 16-byte aligned, the same kernel runs with one channel per thread.
// Offsets are 64-bit: N*H*W*C passes 2^31 at batch 256, 480x640, C = 32.
// Comparisons are explicit (no fmaxf or __hmax, which drop NaN) and made in
// f32, which holds every bf16 value exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t{1} << 20;  // grid-stride beyond this

// The unsigned type of a given size: one memory access of that many bytes.
template <int Bytes>
struct Word;
template <>
struct Word<1> { using type = uint8_t; };
template <>
struct Word<2> { using type = uint16_t; };
template <>
struct Word<4> { using type = uint32_t; };
template <>
struct Word<8> { using type = uint2; };
template <>
struct Word<16> { using type = uint4; };

// V lanes of raw bits, loaded and stored as one word.
template <typename Lane, int V>
union Pack {
  typename Word<sizeof(Lane) * V>::type word;
  Lane lane[V];
};

template <typename Lane, int V>
__device__ __forceinline__ Pack<Lane, V> load(const Lane* p) {
  Pack<Lane, V> out;
  out.word = *reinterpret_cast<const typename Word<sizeof(Lane) * V>::type*>(p);
  return out;
}

// 16- and 8-byte words go through the st.global.wb intrinsic: written as a
// plain assignment, the compiler splits the backward's four 16-byte stores
// into 4-byte ones (seen in its PTX), which ran K3 at 38% of its byte bound
// over the StereoUNet's four levels on an H100 SXM at 700 W.
template <typename Lane, int V>
__device__ __forceinline__ void store(Lane* p, const Pack<Lane, V>& v) {
  using W = typename Word<sizeof(Lane) * V>::type;
  if constexpr (sizeof(W) >= 8) {
    __stwb(reinterpret_cast<W*>(p), v.word);
  } else {
    *reinterpret_cast<W*>(p) = v.word;
  }
}

// A lane's value: f32 bits as they are, bf16 bits as the top half of an f32.
__device__ __forceinline__ float value(uint32_t bits) { return __uint_as_float(bits); }
__device__ __forceinline__ float value(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// jnp.maximum: NaN wins from either side.
template <typename Lane>
__device__ __forceinline__ Lane max_nan(Lane a, Lane b) {
  const float fa = value(a), fb = value(b);
  return (fa > fb || fa != fa) ? a : b;
}

// Thread t of the flattened (N*H/2*W/2, C/V) grid: the offset of its
// window's top-left element in x and of its output in y.
struct Offsets {
  int64_t in, out;
};

__device__ __forceinline__ Offsets offsets(int64_t t, int64_t groups, int64_t w2,
                                           int64_t row, int64_t c, int v) {
  const int64_t pixel = t / groups;          // output pixel over N*H/2*W/2
  const int64_t g = t - pixel * groups;      // channel group
  const int64_t nh = pixel / w2;             // n*H/2 + oh
  const int64_t ow = pixel - nh * w2;
  return {2 * nh * row + 2 * ow * c + g * v, pixel * c + g * v};
}

template <typename Lane, int V>
__global__ void __launch_bounds__(kThreads)
maxpool2x2_fwd_kernel(const Lane* __restrict__ x, Lane* __restrict__ y,
                      uint8_t* __restrict__ idx, int64_t total, int64_t groups, int64_t w2,
                      int64_t row, int64_t c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const Offsets o = offsets(t, groups, w2, row, c, V);
    const Pack<Lane, V> a0 = load<Lane, V>(x + o.in);
    const Pack<Lane, V> a1 = load<Lane, V>(x + o.in + c);
    const Pack<Lane, V> b0 = load<Lane, V>(x + o.in + row);
    const Pack<Lane, V> b1 = load<Lane, V>(x + o.in + row + c);
    Pack<Lane, V> out;
    Pack<uint8_t, V> sel;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const Lane m = max_nan(max_nan(a0.lane[k], a1.lane[k]), max_nan(b0.lane[k], b1.lane[k]));
      const float fm = value(m);
      out.lane[k] = m;
      sel.lane[k] = value(a0.lane[k]) >= fm ? 0
                  : value(a1.lane[k]) >= fm ? 1
                  : value(b0.lane[k]) >= fm ? 2
                                            : 3;
    }
    store(y + o.out, out);
    store(idx + o.out, sel);
  }
}

template <typename Lane, int V>
__global__ void __launch_bounds__(kThreads)
maxpool2x2_bwd_kernel(const Lane* __restrict__ dy, const uint8_t* __restrict__ idx,
                      Lane* __restrict__ dx, int64_t total, int64_t groups, int64_t w2,
                      int64_t row, int64_t c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const Offsets o = offsets(t, groups, w2, row, c, V);
    const Pack<Lane, V> d = load<Lane, V>(dy + o.out);
    const Pack<uint8_t, V> sel = load<uint8_t, V>(idx + o.out);
    Pack<Lane, V> p0, p1, p2, p3;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const uint8_t s = sel.lane[k];
      const Lane v = d.lane[k];
      p0.lane[k] = s == 0 ? v : Lane{0};
      p1.lane[k] = s == 1 ? v : Lane{0};
      p2.lane[k] = s == 2 ? v : Lane{0};
      p3.lane[k] = s == 3 ? v : Lane{0};
    }
    store(dx + o.in, p0);
    store(dx + o.in + c, p1);
    store(dx + o.in + row, p2);
    store(dx + o.in + row + c, p3);
  }
}

unsigned int blocks_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// Lanes per 16-byte word: 4 f32 or 8 bf16.
template <typename Lane>
constexpr int kVec = 16 / static_cast<int>(sizeof(Lane));

// The 16-byte path takes C in whole 16-byte groups and 16-byte aligned
// pointers (the offsets are then multiples of a group); anything else takes
// one channel a thread.
template <typename Lane>
bool vectorizable(int64_t c, const void* a, const void* b, const void* i) {
  const auto bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(i);
  return c % kVec<Lane> == 0 && bits % 16 == 0;
}

// One launch at vector width kVec (16 bytes of channels a thread) or 1.
template <typename Lane>
void launch_fwd(const void* x, void* y, void* idx, int64_t n, int64_t h, int64_t w,
                int64_t c, cudaStream_t stream) {
  const bool vec = vectorizable<Lane>(c, x, y, idx);
  const int v = vec ? kVec<Lane> : 1;
  const int64_t groups = c / v;
  const int64_t w2 = w / 2;
  const int64_t total = n * (h / 2) * w2 * groups;
  const auto* xs = static_cast<const Lane*>(x);
  auto* ys = static_cast<Lane*>(y);
  auto* is = static_cast<uint8_t*>(idx);
  if (vec) {
    maxpool2x2_fwd_kernel<Lane, kVec<Lane>><<<blocks_for(total), kThreads, 0, stream>>>(
        xs, ys, is, total, groups, w2, w * c, c);
  } else {
    maxpool2x2_fwd_kernel<Lane, 1><<<blocks_for(total), kThreads, 0, stream>>>(
        xs, ys, is, total, groups, w2, w * c, c);
  }
}

template <typename Lane>
void launch_bwd(const void* dy, const void* idx, void* dx, int64_t n, int64_t h, int64_t w,
                int64_t c, cudaStream_t stream) {
  const bool vec = vectorizable<Lane>(c, dy, idx, dx);
  const int v = vec ? kVec<Lane> : 1;
  const int64_t groups = c / v;
  const int64_t w2 = w / 2;
  const int64_t total = n * (h / 2) * w2 * groups;
  const auto* ds = static_cast<const Lane*>(dy);
  const auto* is = static_cast<const uint8_t*>(idx);
  auto* xs = static_cast<Lane*>(dx);
  if (vec) {
    maxpool2x2_bwd_kernel<Lane, kVec<Lane>><<<blocks_for(total), kThreads, 0, stream>>>(
        ds, is, xs, total, groups, w2, w * c, c);
  } else {
    maxpool2x2_bwd_kernel<Lane, 1><<<blocks_for(total), kThreads, 0, stream>>>(
        ds, is, xs, total, groups, w2, w * c, c);
  }
}

bool valid_shape(int64_t n, int64_t h, int64_t w, int64_t c) {
  return n > 0 && h > 0 && w > 0 && c > 0 && h % 2 == 0 && w % 2 == 0;
}

}  // namespace

extern "C" {

const char* maxpool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: (n, h, w, c) contiguous, f32 (is_bf16 = 0) or bf16; y: (n, h/2, w/2, c)
// same dtype; idx: (n, h/2, w/2, c) uint8. Takes 16 bytes of channels a thread
// where c and the pointers allow it, else one channel. Launches on `stream`
// and returns cudaGetLastError().
int maxpool2x2_fwd(const void* x, void* y, void* idx, int64_t n, int64_t h, int64_t w,
                   int64_t c, int is_bf16, void* stream) {
  if (!valid_shape(n, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_fwd<uint16_t>(x, y, idx, n, h, w, c, s);
  } else {
    launch_fwd<uint32_t>(x, y, idx, n, h, w, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// dy: (n, h/2, w/2, c) f32 or bf16; idx: (n, h/2, w/2, c) uint8; dx: (n, h, w,
// c) in dy's dtype, every element written. Same width rule as the forward.
int maxpool2x2_bwd(const void* dy, const void* idx, void* dx, int64_t n, int64_t h,
                   int64_t w, int64_t c, int is_bf16, void* stream) {
  if (!valid_shape(n, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_bwd<uint16_t>(dy, idx, dx, n, h, w, c, s);
  } else {
    launch_bwd<uint32_t>(dy, idx, dx, n, h, w, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
