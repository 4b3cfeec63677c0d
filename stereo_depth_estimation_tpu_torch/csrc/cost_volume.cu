// PSMNet's concatenation cost volume, forward and backward, NHWC features and
// an NDHWC volume, sm_90a.
//
// cost_volume_fwd: left and right features (N, H, W, C) f32 or bf16 -> the
// volume V (N, D, H, W, 2C) in their dtype, where
//   V[n, d, h, w, c]     = left[n, h, w, c]          for w >= d, else 0,
//   V[n, d, h, w, C + c] = right[n, h, w - d, c]     for w >= d, else 0.
// cost_volume_bwd: dV (N, D, H, W, 2C) -> dleft, dright (N, H, W, C), where
//   dleft[n, h, w, c]  = sum over d <= w of dV[n, d, h, w, c],
//   dright[n, h, w, c] = sum over d with w + d < W of dV[n, d, h, w + d, C + c],
// each sum taken in f32, d ascending, and stored in dV's dtype.
//
// It replaces no TPU kernel: the JAX package has no cost-volume model. The
// published PSMNet (github.com/JiaRenChang/PSMNet, models/stackhourglass.py)
// builds the volume with a Python loop of D slice copies (2D launches
// forward, as many slice-adds backward); this is one launch each way. The
// (N, D, H, W, 2C) layout is the channels_last_3d memory of the (N, 2C, D, H,
// W) volume the first 3D convolution reads, so no layout copy follows it.
//
// What bounds them: memory. The forward writes N*D*H*W*2C elements and reads
// the features' 2*N*H*W*C; the backward reads the former and writes the
// latter. At PSMNet's published size (batch 12, 256x512 crops, H/4 x W/4 =
// 64 x 128, D = 192/4 = 48, C = 32, bf16) that is 604.0 MB written and 6.3
// MB read, about 182 us at 3.35 TB/s, each way.
//
// What the design does about it: every element of V is written once, as
// 16-byte words (8 bf16 or 4 f32 lanes of one pixel's channels), by
// neighbouring threads at neighbouring addresses; the features, read again
// for every d, stay in L2 (6.3 MB at the published size). The zero band
// w < d is written by the same threads, so V needs no fill pass. In the
// backward a thread owns 16 bytes of one feature pixel's channels and walks
// d, reading one 16-byte word of dV per step (the dright half on the
// diagonal w + d), so neighbouring threads read neighbouring addresses for
// each d and every element of dV is read once. Where C does not divide into
// 16-byte groups, or a pointer is not 16-byte aligned, the same kernels run
// with one channel a thread. Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t{1} << 20;  // grid-stride beyond this

template <int Bytes>
struct Word;
template <>
struct Word<2> { using type = uint16_t; };
template <>
struct Word<4> { using type = uint32_t; };
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

// 16-byte words go through st.global.wb, so the compiler cannot split them.
template <typename Lane, int V>
__device__ __forceinline__ void store(Lane* p, const Pack<Lane, V>& v) {
  using W = typename Word<sizeof(Lane) * V>::type;
  if constexpr (sizeof(W) == 16) {
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

// A value stored in a lane: f32 as it is, bf16 rounded to nearest even (as
// PyTorch's .to(torch.bfloat16)).
template <typename Lane>
__device__ __forceinline__ Lane lane_of(float v);
template <>
__device__ __forceinline__ uint32_t lane_of<uint32_t>(float v) { return __float_as_uint(v); }
template <>
__device__ __forceinline__ uint16_t lane_of<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The volume's element group t (of V lanes) over (N, D, H, W, 2C / V): a
// copy of the left or the shifted right features' group, or zeros.
template <typename Lane, int V>
__global__ void __launch_bounds__(kThreads)
cost_volume_fwd_kernel(const Lane* __restrict__ left, const Lane* __restrict__ right,
                       Lane* __restrict__ out, int64_t total, int64_t depth, int64_t h,
                       int64_t w, int64_t c) {
  const int64_t groups = c / V;  // per half
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    int64_t rest = t / (2 * groups);
    const int64_t g = t - rest * (2 * groups);
    const int64_t x = rest % w;
    rest /= w;
    const int64_t y = rest % h;
    rest /= h;
    const int64_t d = rest % depth;
    const int64_t n = rest / depth;
    Pack<Lane, V> v;
    if (x < d) {
#pragma unroll
      for (int k = 0; k < V; ++k) v.lane[k] = Lane{0};
    } else if (g < groups) {
      v = load<Lane, V>(left + ((n * h + y) * w + x) * c + g * V);
    } else {
      v = load<Lane, V>(right + ((n * h + y) * w + (x - d)) * c + (g - groups) * V);
    }
    store(out + t * V, v);
  }
}

// The features' group t (of V lanes) over (N, H, W, 2C / V): the first C / V
// groups of a pixel are dleft's, the rest dright's.
template <typename Lane, int V>
__global__ void __launch_bounds__(kThreads)
cost_volume_bwd_kernel(const Lane* __restrict__ dv, Lane* __restrict__ dleft,
                       Lane* __restrict__ dright, int64_t total, int64_t depth, int64_t h,
                       int64_t w, int64_t c) {
  const int64_t groups = c / V;  // per half
  const int64_t plane = h * w * 2 * c;  // dV's elements of one d
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t pixel = t / (2 * groups);  // over N*H*W
    const int64_t g = t - pixel * (2 * groups);
    const int64_t x = pixel % w;
    const int64_t n = pixel / (h * w);
    const int64_t hw = pixel - n * h * w;  // y * w + x
    const bool is_left = g < groups;
    // dleft at x: d = 0..min(D-1, x) at column x; dright at x: d = 0..
    // min(D-1, W-1-x) at column x + d, the right half's channels.
    const int64_t steps = is_left ? (x < depth - 1 ? x : depth - 1) + 1
                                  : (w - 1 - x < depth - 1 ? w - 1 - x : depth - 1) + 1;
    const int64_t step = is_left ? plane : plane + 2 * c;
    const Lane* p = dv + (n * depth * h * w + hw) * 2 * c + g * V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int64_t d = 0; d < steps; ++d) {
      const Pack<Lane, V> v = load<Lane, V>(p + d * step);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] += value(v.lane[k]);
    }
    Pack<Lane, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) out.lane[k] = lane_of<Lane>(acc[k]);
    Lane* dst = is_left ? dleft + pixel * c + g * V : dright + pixel * c + (g - groups) * V;
    store(dst, out);
  }
}

unsigned int blocks_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// Lanes per 16-byte word: 4 f32 or 8 bf16.
template <typename Lane>
constexpr int kVec = 16 / static_cast<int>(sizeof(Lane));

template <typename Lane>
bool vectorizable(int64_t c, const void* a, const void* b, const void* o) {
  const auto bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(o);
  return c % kVec<Lane> == 0 && bits % 16 == 0;
}

template <typename Lane>
void launch_fwd(const void* left, const void* right, void* out, int64_t n, int64_t depth,
                int64_t h, int64_t w, int64_t c, cudaStream_t stream) {
  const auto* l = static_cast<const Lane*>(left);
  const auto* r = static_cast<const Lane*>(right);
  auto* o = static_cast<Lane*>(out);
  if (vectorizable<Lane>(c, left, right, out)) {
    constexpr int V = kVec<Lane>;
    const int64_t total = n * depth * h * w * (2 * c / V);
    cost_volume_fwd_kernel<Lane, V><<<blocks_for(total), kThreads, 0, stream>>>(
        l, r, o, total, depth, h, w, c);
  } else {
    const int64_t total = n * depth * h * w * 2 * c;
    cost_volume_fwd_kernel<Lane, 1><<<blocks_for(total), kThreads, 0, stream>>>(
        l, r, o, total, depth, h, w, c);
  }
}

template <typename Lane>
void launch_bwd(const void* dv, void* dleft, void* dright, int64_t n, int64_t depth,
                int64_t h, int64_t w, int64_t c, cudaStream_t stream) {
  const auto* g = static_cast<const Lane*>(dv);
  auto* l = static_cast<Lane*>(dleft);
  auto* r = static_cast<Lane*>(dright);
  if (vectorizable<Lane>(c, dv, dleft, dright)) {
    constexpr int V = kVec<Lane>;
    const int64_t total = n * h * w * (2 * c / V);
    cost_volume_bwd_kernel<Lane, V><<<blocks_for(total), kThreads, 0, stream>>>(
        g, l, r, total, depth, h, w, c);
  } else {
    const int64_t total = n * h * w * 2 * c;
    cost_volume_bwd_kernel<Lane, 1><<<blocks_for(total), kThreads, 0, stream>>>(
        g, l, r, total, depth, h, w, c);
  }
}

bool valid_shape(int64_t n, int64_t depth, int64_t h, int64_t w, int64_t c) {
  return n > 0 && depth > 0 && h > 0 && w > 0 && c > 0;
}

}  // namespace

extern "C" {

const char* cost_volume_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// left, right: (n, h, w, c) contiguous, f32 (is_bf16 = 0) or bf16; out: (n,
// depth, h, w, 2c) in their dtype, every element written. Launches on
// `stream` and returns cudaGetLastError().
int cost_volume_fwd(const void* left, const void* right, void* out, int64_t n,
                    int64_t depth, int64_t h, int64_t w, int64_t c, int is_bf16,
                    void* stream) {
  if (!valid_shape(n, depth, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_fwd<uint16_t>(left, right, out, n, depth, h, w, c, s);
  } else {
    launch_fwd<uint32_t>(left, right, out, n, depth, h, w, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// dv: (n, depth, h, w, 2c) contiguous, f32 or bf16; dleft, dright: (n, h, w,
// c) in dv's dtype, every element written.
int cost_volume_bwd(const void* dv, void* dleft, void* dright, int64_t n, int64_t depth,
                    int64_t h, int64_t w, int64_t c, int is_bf16, void* stream) {
  if (!valid_shape(n, depth, h, w, c)) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_bwd<uint16_t>(dv, dleft, dright, n, depth, h, w, c, s);
  } else {
    launch_bwd<uint32_t>(dv, dleft, dright, n, depth, h, w, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
