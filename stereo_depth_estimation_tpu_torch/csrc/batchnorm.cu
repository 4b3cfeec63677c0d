// Batch-statistic BatchNorm + optional ReLU on the model's channels_last
// activations, forward and backward, sm_90a. Four kernels, BN1-BN4:
//
//   BN1 bn_stats          per-channel sum and sum of squares of x and the
//                         element count, (2C + 1) f32 (the layout of
//                         models/unet.py _moment_sums); in bf16-statistics
//                         mode each sum is n times the bf16-rounded mean.
//   BN2 bn_relu_fwd       y = (x - mean) * scale + beta in f32, ReLU if asked,
//                         stored in x's dtype (scale = gamma * rsqrt(var + eps)).
//   BN3 bn_relu_bwd_sums  sum of dyp and of dyp * (z - mean), (2C) f32, where
//                         dyp = dy where BN2's pre-activation is > 0, else 0
//                         (dyp = dy with the ReLU off).
//   BN4 bn_relu_bwd_dx    dz = dyp * scale - t1 - (z - mean) * t2, stored in z's
//                         dtype, from the (C,) coefficients t1 and t2.
//
// They are not TPU kernels: in the JAX package this arithmetic is fused by
// XLA into the neighbouring ops. They stand for the flax BatchNorm of
// stereo_depth_estimation_tpu/models/unet.py:67-70 (statistics) and :86-88
// (normalisation), and for the fused block's _fcbr_fwd_math :133-138 and
// _fcbr_bwd :183-200 (the textbook batch-statistic backward with the ReLU
// mask recomputed from z).
//
// Layout: the activation is an (M = N*H*W, C) row-major matrix, C contiguous
// (a channels_last NCHW tensor or a height stripe of one). Types: x, y, dy, z
// and dz are f32 or bf16 (all of one call in one dtype); statistics and
// coefficients are f32.
//
// What bounds them: memory. BN1 reads x once, BN2 reads x and writes y, BN3
// reads dy and z, BN4 reads dy and z and writes dz; each does a few flops
// per element. At the StereoUNet's 18 BatchNorms (batch 128, 240x320, base
// 32, bf16) one pass over their inputs is 4.80 GB, so a step's bounds at
// 3.35 TB/s are 1.43 ms (BN1), 2.87 ms (BN2), 2.87 ms (BN3), 4.30 ms (BN4).
//
// What the design does about it:
// - A thread owns a fixed group of channels (16 bytes: 4 f32 or 8 bf16,
//   moved as one uint4; one channel where C or a pointer does not allow it)
//   and walks rows, so its per-channel coefficients sit in registers and
//   every load is 16 bytes, neighbouring threads on neighbouring addresses.
//   A block of 256 threads is (256 / groups-per-block) rows by the channel
//   groups.
// - Reductions (BN1, BN3) are deterministic, with no float atomics: each
//   block reduces its rows in registers, then over its thread rows in
//   shared memory in a fixed order, and writes one row of per-channel
//   partials; a second kernel sums the partials of each channel in a fixed
//   order (32 strided partitions, then a fixed tree). The split depends on
//   the shape alone, so two launches give the same bytes.
// - Rows are cut into enough blocks to fill the 132 SMs even at the fifth
//   level's 38,400 rows of 512 channels, with at least 8 rows a thread.
// - BN2, BN3 and BN4 compute the pre-activation with the same correctly
//   rounded sub, mul and add (__fsub_rn, __fmul_rn, __fadd_rn: no FMA
//   contraction), as the plain versions' separate PyTorch ops do, so the
//   backward's ReLU mask is bitwise the forward's.
// - Offsets are 64-bit: M*C passes 2^31 at the first level of batch 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
// Blocks of a reduction: 8 resident 256-thread blocks on each of an H100's
// 132 SMs. The wrapper sizes the partials' scratch by this (bn_max_chunks).
constexpr int kMaxChunks = 132 * 8;
// Elementwise grids stride over rows beyond this many blocks.
constexpr int kMaxElementwiseBlocks = 132 * 16;
// A reduction thread walks at least this many rows.
constexpr int kMinRowsPerThread = 8;
// The partials' second pass: 32 channels by 32 partitions a block.
constexpr int kFinalCols = 32;
constexpr int kFinalParts = 32;

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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// BN2's pre-activation; BN3 and BN4 recompute it bitwise.
__device__ __forceinline__ float pre_activation(float x, float mean, float scale, float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), scale), beta);
}

// The split of an (m, c) matrix over blocks of kThreads threads.
struct Tiling {
  int64_t m, c;
  int groups;  // channel groups of V channels: c / V
  int gpb;     // groups a block covers: min(groups, kThreads)
  int rpi;     // rows a block covers at once: kThreads / gpb
  int tiles;   // channel tiles (gridDim.y): ceil(groups / gpb)
  int64_t rows_per_chunk;  // reductions: the rows of one block (gridDim.x)
  int chunks;
};

Tiling make_tiling(int64_t m, int64_t c, int v) {
  Tiling t{};
  t.m = m;
  t.c = c;
  t.groups = static_cast<int>(c / v);
  t.gpb = t.groups < kThreads ? t.groups : kThreads;
  t.rpi = kThreads / t.gpb;
  t.tiles = (t.groups + t.gpb - 1) / t.gpb;
  const int64_t most = kMaxChunks / t.tiles;
  const int64_t row_steps = (m + t.rpi - 1) / t.rpi;
  int64_t chunks = (row_steps + kMinRowsPerThread - 1) / kMinRowsPerThread;
  chunks = chunks < most ? chunks : most;
  chunks = chunks > 0 ? chunks : 1;
  t.rows_per_chunk = (m + chunks - 1) / chunks;
  t.rows_per_chunk = t.rows_per_chunk > 0 ? t.rows_per_chunk : 1;
  t.chunks = static_cast<int>((m + t.rows_per_chunk - 1) / t.rows_per_chunk);
  return t;
}

// A block's two (rows x channels) register sums, reduced over its thread
// rows in a fixed order, written as this chunk's row of partials: columns
// [0, c) the first sum, [c, 2c) the second.
template <int V>
__device__ __forceinline__ void store_partials(const float (&s)[V], const float (&q)[V],
                                               float* __restrict__ partial,
                                               const Tiling& t) {
  __shared__ float sh[2][kThreads * V];
  const int r = threadIdx.x / t.gpb, gl = threadIdx.x % t.gpb;
  const int width = t.gpb * V;
  if (r < t.rpi) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sh[0][r * width + gl * V + k] = s[k];
      sh[1][r * width + gl * V + k] = q[k];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < 2 * width; col += kThreads) {
    const int which = col / width, j = col - which * width;
    const int64_t channel = static_cast<int64_t>(blockIdx.y) * width + j;
    if (channel >= t.c) continue;
    float acc = 0.0f;
    for (int rr = 0; rr < t.rpi; ++rr) acc = __fadd_rn(acc, sh[which][rr * width + j]);
    partial[static_cast<int64_t>(blockIdx.x) * 2 * t.c + which * t.c + channel] = acc;
  }
}

// BN1, first pass: this chunk's per-channel sum of x and of x*x (in
// bf16-statistics mode of bf16(x) and of bf16(bf16(x)^2)).
template <typename Lane, int V, bool kBf16Stats>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial(const Lane* __restrict__ x, float* __restrict__ partial, Tiling t) {
  const int r = threadIdx.x / t.gpb, gl = threadIdx.x % t.gpb;
  const int g = blockIdx.y * t.gpb + gl;
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.0f;
  if (r < t.rpi && g < t.groups) {
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * t.rows_per_chunk;
    const int64_t end = row0 + t.rows_per_chunk;
    const int64_t row1 = end < t.m ? end : t.m;
    const Lane* base = x + static_cast<int64_t>(g) * V;
    for (int64_t row = row0 + r; row < row1; row += t.rpi) {
      const Pack<Lane, V> p = load<Lane, V>(base + row * t.c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float v = value(p.lane[k]);
        if constexpr (kBf16Stats) v = round_bf16(v);
        float sq = __fmul_rn(v, v);
        if constexpr (kBf16Stats) sq = round_bf16(sq);
        s[k] = __fadd_rn(s[k], v);
        q[k] = __fadd_rn(q[k], sq);
      }
    }
  }
  store_partials<V>(s, q, partial, t);
}

// BN3, first pass: this chunk's per-channel sum of dyp and of dyp * (z - mean).
template <typename Lane, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_bwd_sums_partial(const Lane* __restrict__ dy, const Lane* __restrict__ z,
                    const float* __restrict__ mean, const float* __restrict__ scale,
                    const float* __restrict__ beta, float* __restrict__ partial, Tiling t) {
  const int r = threadIdx.x / t.gpb, gl = threadIdx.x % t.gpb;
  const int g = blockIdx.y * t.gpb + gl;
  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = q[k] = 0.0f;
  if (r < t.rpi && g < t.groups) {
    float mu[V], sc[V], be[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      mu[k] = mean[g * V + k];
      sc[k] = scale[g * V + k];
      be[k] = beta[g * V + k];
    }
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * t.rows_per_chunk;
    const int64_t end = row0 + t.rows_per_chunk;
    const int64_t row1 = end < t.m ? end : t.m;
    const int64_t col = static_cast<int64_t>(g) * V;
    for (int64_t row = row0 + r; row < row1; row += t.rpi) {
      const Pack<Lane, V> d = load<Lane, V>(dy + row * t.c + col);
      const Pack<Lane, V> zz = load<Lane, V>(z + row * t.c + col);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float zv = value(zz.lane[k]);
        float dyp = value(d.lane[k]);
        if constexpr (kRelu) {
          if (!(pre_activation(zv, mu[k], sc[k], be[k]) > 0.0f)) dyp = 0.0f;
        }
        s[k] = __fadd_rn(s[k], dyp);
        q[k] = __fadd_rn(q[k], __fmul_rn(dyp, __fsub_rn(zv, mu[k])));
      }
    }
  }
  store_partials<V>(s, q, partial, t);
}

// Second pass of BN1 and BN3: out[j] = the sum over the chunks' partials of
// column j, in a fixed order; BN1 in bf16-statistics mode replaces each sum
// by n * bf16(sum / n), and BN1 writes the count n after the 2c sums.
__global__ void __launch_bounds__(kFinalCols * kFinalParts)
bn_sums_final(const float* __restrict__ partial, float* __restrict__ out, int chunks,
              int64_t width, float n, int bf16_mean, int write_count) {
  __shared__ float sh[kFinalParts][kFinalCols + 1];
  const int jl = threadIdx.x % kFinalCols, p = threadIdx.x / kFinalCols;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kFinalCols + jl;
  float acc = 0.0f;
  if (j < width) {
    for (int b = p; b < chunks; b += kFinalParts) {
      acc = __fadd_rn(acc, partial[static_cast<int64_t>(b) * width + j]);
    }
  }
  sh[p][jl] = acc;
  __syncthreads();
  for (int half = kFinalParts / 2; half > 0; half /= 2) {
    if (p < half) sh[p][jl] = __fadd_rn(sh[p][jl], sh[p + half][jl]);
    __syncthreads();
  }
  if (p == 0 && j < width) {
    float total = sh[0][jl];
    if (bf16_mean) total = __fmul_rn(round_bf16(__fdiv_rn(total, n)), n);
    out[j] = total;
  }
  if (write_count && blockIdx.x == 0 && threadIdx.x == 0) out[width] = n;
}

// BN2: y = (x - mean) * scale + beta, ReLU'd if kRelu, in x's dtype.
template <typename Lane, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_relu_fwd_kernel(const Lane* __restrict__ x, const float* __restrict__ mean,
                   const float* __restrict__ scale, const float* __restrict__ beta,
                   Lane* __restrict__ y, Tiling t) {
  const int r = threadIdx.x / t.gpb, gl = threadIdx.x % t.gpb;
  const int g = blockIdx.y * t.gpb + gl;
  if (r >= t.rpi || g >= t.groups) return;
  float mu[V], sc[V], be[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mu[k] = mean[g * V + k];
    sc[k] = scale[g * V + k];
    be[k] = beta[g * V + k];
  }
  const int64_t col = static_cast<int64_t>(g) * V;
  const int64_t step = static_cast<int64_t>(gridDim.x) * t.rpi;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * t.rpi + r; row < t.m; row += step) {
    const Pack<Lane, V> p = load<Lane, V>(x + row * t.c + col);
    Pack<Lane, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float v = pre_activation(value(p.lane[k]), mu[k], sc[k], be[k]);
      // torch.relu: NaN stays NaN.
      if constexpr (kRelu) v = (v > 0.0f || v != v) ? v : 0.0f;
      out.lane[k] = lane_of<Lane>(v);
    }
    store<Lane, V>(y + row * t.c + col, out);
  }
}

// BN4: dz = dyp * scale - t1 - (z - mean) * t2, in z's dtype.
template <typename Lane, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_relu_bwd_dx_kernel(const Lane* __restrict__ dy, const Lane* __restrict__ z,
                      const float* __restrict__ mean, const float* __restrict__ scale,
                      const float* __restrict__ beta, const float* __restrict__ t1,
                      const float* __restrict__ t2, Lane* __restrict__ dz, Tiling t) {
  const int r = threadIdx.x / t.gpb, gl = threadIdx.x % t.gpb;
  const int g = blockIdx.y * t.gpb + gl;
  if (r >= t.rpi || g >= t.groups) return;
  float mu[V], sc[V], be[V], a[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mu[k] = mean[g * V + k];
    sc[k] = scale[g * V + k];
    be[k] = beta[g * V + k];
    a[k] = t1[g * V + k];
    b[k] = t2[g * V + k];
  }
  const int64_t col = static_cast<int64_t>(g) * V;
  const int64_t step = static_cast<int64_t>(gridDim.x) * t.rpi;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * t.rpi + r; row < t.m; row += step) {
    const Pack<Lane, V> d = load<Lane, V>(dy + row * t.c + col);
    const Pack<Lane, V> zz = load<Lane, V>(z + row * t.c + col);
    Pack<Lane, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float zv = value(zz.lane[k]);
      float dyp = value(d.lane[k]);
      if constexpr (kRelu) {
        if (!(pre_activation(zv, mu[k], sc[k], be[k]) > 0.0f)) dyp = 0.0f;
      }
      const float v = __fsub_rn(__fsub_rn(__fmul_rn(dyp, sc[k]), a[k]),
                                __fmul_rn(__fsub_rn(zv, mu[k]), b[k]));
      out.lane[k] = lane_of<Lane>(v);
    }
    store<Lane, V>(dz + row * t.c + col, out);
  }
}

// Lanes per 16-byte word: 4 f32 or 8 bf16.
template <typename Lane>
constexpr int kVec = 16 / static_cast<int>(sizeof(Lane));

// The 16-byte path takes C in whole 16-byte groups and 16-byte aligned
// pointers (every row then starts on a group); else one channel a thread.
template <typename Lane>
bool vectorizable(int64_t c, std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return c % kVec<Lane> == 0 && bits % 16 == 0;
}

unsigned int elementwise_blocks(const Tiling& t) {
  const int64_t blocks = (t.m + t.rpi - 1) / t.rpi;
  return static_cast<unsigned int>(blocks < kMaxElementwiseBlocks ? blocks
                                                                  : kMaxElementwiseBlocks);
}

void launch_final(const float* partial, float* out, int chunks, int64_t width, int64_t m,
                  int bf16_mean, int write_count, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((width + kFinalCols - 1) / kFinalCols);
  bn_sums_final<<<blocks, kFinalCols * kFinalParts, 0, stream>>>(
      partial, out, chunks, width, static_cast<float>(m), bf16_mean, write_count);
}

template <typename Lane, int V>
void stats(const void* x, float* out, float* partial, int64_t m, int64_t c, int bf16_stats,
           cudaStream_t stream) {
  const Tiling t = make_tiling(m, c, V);
  const int chunks = m > 0 ? t.chunks : 0;
  if (chunks > 0) {
    const dim3 grid(static_cast<unsigned int>(chunks), static_cast<unsigned int>(t.tiles));
    const auto* xs = static_cast<const Lane*>(x);
    if (bf16_stats) {
      bn_stats_partial<Lane, V, true><<<grid, kThreads, 0, stream>>>(xs, partial, t);
    } else {
      bn_stats_partial<Lane, V, false><<<grid, kThreads, 0, stream>>>(xs, partial, t);
    }
  }
  launch_final(partial, out, chunks, 2 * c, m, bf16_stats, 1, stream);
}

template <typename Lane, int V>
void bwd_sums(const void* dy, const void* z, const float* mean, const float* scale,
              const float* beta, float* out, float* partial, int64_t m, int64_t c, int relu,
              cudaStream_t stream) {
  const Tiling t = make_tiling(m, c, V);
  const int chunks = m > 0 ? t.chunks : 0;
  if (chunks > 0) {
    const dim3 grid(static_cast<unsigned int>(chunks), static_cast<unsigned int>(t.tiles));
    const auto* d = static_cast<const Lane*>(dy);
    const auto* zs = static_cast<const Lane*>(z);
    if (relu) {
      bn_bwd_sums_partial<Lane, V, true><<<grid, kThreads, 0, stream>>>(
          d, zs, mean, scale, beta, partial, t);
    } else {
      bn_bwd_sums_partial<Lane, V, false><<<grid, kThreads, 0, stream>>>(
          d, zs, mean, scale, beta, partial, t);
    }
  }
  launch_final(partial, out, chunks, 2 * c, m, 0, 0, stream);
}

template <typename Lane, int V>
void fwd(const void* x, const float* mean, const float* scale, const float* beta, void* y,
         int64_t m, int64_t c, int relu, cudaStream_t stream) {
  const Tiling t = make_tiling(m, c, V);
  const dim3 grid(elementwise_blocks(t), static_cast<unsigned int>(t.tiles));
  const auto* xs = static_cast<const Lane*>(x);
  auto* ys = static_cast<Lane*>(y);
  if (relu) {
    bn_relu_fwd_kernel<Lane, V, true><<<grid, kThreads, 0, stream>>>(xs, mean, scale, beta,
                                                                     ys, t);
  } else {
    bn_relu_fwd_kernel<Lane, V, false><<<grid, kThreads, 0, stream>>>(xs, mean, scale, beta,
                                                                      ys, t);
  }
}

template <typename Lane, int V>
void bwd_dx(const void* dy, const void* z, const float* mean, const float* scale,
            const float* beta, const float* t1, const float* t2, void* dz, int64_t m,
            int64_t c, int relu, cudaStream_t stream) {
  const Tiling t = make_tiling(m, c, V);
  const dim3 grid(elementwise_blocks(t), static_cast<unsigned int>(t.tiles));
  const auto* d = static_cast<const Lane*>(dy);
  const auto* zs = static_cast<const Lane*>(z);
  auto* out = static_cast<Lane*>(dz);
  if (relu) {
    bn_relu_bwd_dx_kernel<Lane, V, true><<<grid, kThreads, 0, stream>>>(
        d, zs, mean, scale, beta, t1, t2, out, t);
  } else {
    bn_relu_bwd_dx_kernel<Lane, V, false><<<grid, kThreads, 0, stream>>>(
        d, zs, mean, scale, beta, t1, t2, out, t);
  }
}

// Dispatch on the element type and the vector width.
#define BN_DISPATCH(is_bf16, vec, fn, ...)                     \
  do {                                                          \
    if (is_bf16) {                                              \
      if (vec) fn<uint16_t, kVec<uint16_t>>(__VA_ARGS__);       \
      else fn<uint16_t, 1>(__VA_ARGS__);                        \
    } else {                                                    \
      if (vec) fn<uint32_t, kVec<uint32_t>>(__VA_ARGS__);       \
      else fn<uint32_t, 1>(__VA_ARGS__);                        \
    }                                                           \
  } while (0)

bool vec_ok(int is_bf16, int64_t c, std::initializer_list<const void*> ptrs) {
  return is_bf16 ? vectorizable<uint16_t>(c, ptrs) : vectorizable<uint32_t>(c, ptrs);
}

bool valid(int64_t m, int64_t c) { return m >= 0 && c > 0; }

}  // namespace

extern "C" {

const char* bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Rows of the partials' scratch a reduction may use; the scratch is
// (bn_max_chunks(), 2c) f32.
int bn_max_chunks() { return kMaxChunks; }

// BN1. x: (m, c) f32 (is_bf16 = 0) or bf16, contiguous; out: (2c + 1) f32;
// partial: scratch of bn_max_chunks() * 2c f32. Launches on `stream` and
// returns cudaGetLastError().
int bn_stats(const void* x, void* out, void* partial, int64_t m, int64_t c, int is_bf16,
             int bf16_stats, void* stream) {
  if (!valid(m, c)) return static_cast<int>(cudaErrorInvalidValue);
  const bool v = vec_ok(is_bf16, c, {x});
  BN_DISPATCH(is_bf16, v, stats, x, static_cast<float*>(out), static_cast<float*>(partial),
              m, c, bf16_stats, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// BN2. x, y: (m, c) in one dtype; mean, scale, beta: (c) f32.
int bn_relu_fwd(const void* x, const void* mean, const void* scale, const void* beta,
                void* y, int64_t m, int64_t c, int is_bf16, int relu, void* stream) {
  if (!valid(m, c)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const bool v = vec_ok(is_bf16, c, {x, y});
  BN_DISPATCH(is_bf16, v, fwd, x, static_cast<const float*>(mean),
              static_cast<const float*>(scale), static_cast<const float*>(beta), y, m, c, relu,
              static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// BN3. dy, z: (m, c) in one dtype; mean, scale, beta: (c) f32; out: (2c) f32;
// partial: scratch of bn_max_chunks() * 2c f32.
int bn_relu_bwd_sums(const void* dy, const void* z, const void* mean, const void* scale,
                     const void* beta, void* out, void* partial, int64_t m, int64_t c,
                     int is_bf16, int relu, void* stream) {
  if (!valid(m, c)) return static_cast<int>(cudaErrorInvalidValue);
  const bool v = vec_ok(is_bf16, c, {dy, z});
  BN_DISPATCH(is_bf16, v, bwd_sums, dy, z, static_cast<const float*>(mean),
              static_cast<const float*>(scale), static_cast<const float*>(beta),
              static_cast<float*>(out), static_cast<float*>(partial), m, c, relu,
              static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// BN4. dy, z, dz: (m, c) in one dtype; mean, scale, beta, t1, t2: (c) f32.
int bn_relu_bwd_dx(const void* dy, const void* z, const void* mean, const void* scale,
                   const void* beta, const void* t1, const void* t2, void* dz, int64_t m,
                   int64_t c, int is_bf16, int relu, void* stream) {
  if (!valid(m, c)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const bool v = vec_ok(is_bf16, c, {dy, z, dz});
  BN_DISPATCH(is_bf16, v, bwd_dx, dy, z, static_cast<const float*>(mean),
              static_cast<const float*>(scale), static_cast<const float*>(beta),
              static_cast<const float*>(t1), static_cast<const float*>(t2), dz, m, c, relu,
              static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
