// Batch-statistic BatchNorm + optional ReLU on the model's channels_last
// activations, forward and backward, sm_90a. Four kernels, BN1-BN4:
//
//   BN1 bn_stats          per-channel sum and sum of squares of x and the
//                         element count (2C + 1 f32); in bf16-statistics mode
//                         each sum is n times the bf16-rounded mean. Its
//                         second pass can also form the statistics, (3C + 1)
//                         f32 = mean, var = E[x^2] - E[x]^2, scale = gamma /
//                         sqrt(var + eps), n, and update nn.BatchNorm2d's
//                         running buffers in place.
//   BN2 bn_relu_fwd       y = (x - mean) * scale + beta in f32, ReLU if asked,
//                         stored in x's dtype.
//   BN3 bn_relu_bwd_sums  sum of dyp and of dyp * (z - mean), (2C) f32, where
//                         dyp = dy where BN2's pre-activation is > 0, else 0
//                         (dyp = dy with the ReLU off). Its second pass can
//                         also form (4C) f32 = dbeta, dgamma and BN4's t1, t2.
//   BN4 bn_relu_bwd_dx    dz = dyp * scale - t1 - (z - mean) * t2, stored in z's
//                         dtype.
//
// A training BatchNorm + ReLU is bn_relu_forward (BN1 with the statistics,
// then BN2) and bn_relu_backward (BN3 with the coefficients, then BN4): six
// launches from two calls.
//
// With a group of several ranks the sums are all-reduced between BN1's (or
// BN3's) second pass and the per-channel arithmetic: that arithmetic is then
// the second pass's kernel alone, run on the reduced sums (bn_moments,
// bn_bwd_coefficients). One kernel, bn_sums_final, does it in every case.
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
// - The per-channel arithmetic runs in the reductions' second pass, so a
//   training BatchNorm + ReLU is six launches and no (C,) op between them;
//   BN2, BN3 and BN4 read the mean and scale that pass wrote once.
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

// What the second pass of BN1 writes for each channel from its two sums
// (a null pointer is not written): the sums and the count (the input of a
// group's all-reduce), and the per-channel epilogue of models/unet.py's
// training BatchNorm: mean, biased var = E[x^2] - E[x]^2, scale = gamma /
// sqrt(var + eps), the count, and nn.BatchNorm2d's running update (unbiased
// var, momentum, num_batches_tracked + 1) in place.
struct StatsEpilogue {
  float* sums;           // (2c + 1): sum, sum of squares, count
  float* stats;          // (3c + 1): mean, var, scale, count
  const float* gamma;    // (c)
  float* running_mean;   // (c), or null: no running update
  float* running_var;    // (c)
  int64_t* tracked;      // (1)
  const float* count;    // the count on the device (after an all-reduce), or null: n
  float n;
  float eps, keep, take;  // keep = 1 - momentum, take = momentum
  int bf16_mean;          // each sum becomes n * bf16(sum / n)
};

// What the second pass of BN3 writes for each channel from its two sums:
// the sums, and BN4's coefficients with the BatchNorm's parameter
// gradients, (4c) = dbeta, dgamma, t1, t2, where dz = dyp * scale - t1 -
// (z - mean) * t2. dbeta and dgamma come from `local` where given (this
// rank's share), t1 and t2 from the sums.
struct GradEpilogue {
  float* sums;         // (2c): sum of dyp, sum of dyp * (z - mean)
  float* coef;         // (4c): dbeta, dgamma, t1, t2
  const float* local;  // (2c), or null: the sums themselves
  const float* stats;  // (3c + 1): the forward's mean, var, scale, count
  float eps;
};

// 1 / sqrt(var + eps), each step correctly rounded (as 1 / torch.sqrt).
__device__ __forceinline__ float inv_std(float var, float eps) {
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
}

__device__ __forceinline__ void finish(const StatsEpilogue& e, int64_t c, int64_t j, float s,
                                       float q) {
  const float n = e.count != nullptr ? *e.count : e.n;
  if (e.bf16_mean) {
    s = __fmul_rn(round_bf16(__fdiv_rn(s, n)), n);
    q = __fmul_rn(round_bf16(__fdiv_rn(q, n)), n);
  }
  if (e.sums != nullptr) {
    e.sums[j] = s;
    e.sums[c + j] = q;
    if (j == 0) e.sums[2 * c] = n;
  }
  if (e.stats == nullptr) return;
  const float mean = __fdiv_rn(s, n);
  const float var = __fsub_rn(__fdiv_rn(q, n), __fmul_rn(mean, mean));
  e.stats[j] = mean;
  e.stats[c + j] = var;
  e.stats[2 * c + j] = __fmul_rn(inv_std(var, e.eps), e.gamma[j]);
  if (j == 0) e.stats[3 * c] = n;
  if (e.running_mean == nullptr) return;
  const float unbiased = __fmul_rn(var, __fdiv_rn(n, fmaxf(__fsub_rn(n, 1.0f), 1.0f)));
  e.running_mean[j] = __fadd_rn(__fmul_rn(e.running_mean[j], e.keep), __fmul_rn(mean, e.take));
  e.running_var[j] = __fadd_rn(__fmul_rn(e.running_var[j], e.keep), __fmul_rn(unbiased, e.take));
  if (j == 0) *e.tracked += 1;
}

__device__ __forceinline__ void finish(const GradEpilogue& e, int64_t c, int64_t j, float s,
                                       float q) {
  if (e.sums != nullptr) {
    e.sums[j] = s;
    e.sums[c + j] = q;
  }
  if (e.coef == nullptr) return;
  const float var = e.stats[c + j], scale = e.stats[2 * c + j], n = e.stats[3 * c];
  const float inv = inv_std(var, e.eps);
  const float ls = e.local != nullptr ? e.local[j] : s;
  const float lq = e.local != nullptr ? e.local[c + j] : q;
  e.coef[j] = ls;
  e.coef[c + j] = __fmul_rn(lq, inv);
  e.coef[2 * c + j] = __fmul_rn(scale, __fdiv_rn(s, n));
  e.coef[3 * c + j] = __fmul_rn(scale, __fdiv_rn(__fmul_rn(inv, __fmul_rn(q, inv)), n));
}

// Second pass of BN1 and BN3: each channel's two sums over the chunks'
// partials (row k: the first sums in [0, c), the second in [c, 2c)), each
// in a fixed order, then the epilogue `e` for the channel. Run on a reduced
// (2c) sum as one chunk it is the epilogue alone (0 + s is s).
template <typename Epilogue>
__global__ void __launch_bounds__(kFinalCols * kFinalParts)
bn_sums_final(const float* __restrict__ partial, int chunks, int64_t c, Epilogue e) {
  __shared__ float sh[2][kFinalParts][kFinalCols + 1];
  const int jl = threadIdx.x % kFinalCols, p = threadIdx.x / kFinalCols;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kFinalCols + jl;
  float s = 0.0f, q = 0.0f;
  if (j < c) {
    for (int b = p; b < chunks; b += kFinalParts) {
      const float* row = partial + static_cast<int64_t>(b) * 2 * c;
      s = __fadd_rn(s, row[j]);
      q = __fadd_rn(q, row[c + j]);
    }
  }
  sh[0][p][jl] = s;
  sh[1][p][jl] = q;
  __syncthreads();
  for (int half = kFinalParts / 2; half > 0; half /= 2) {
    if (p < half) {
      sh[0][p][jl] = __fadd_rn(sh[0][p][jl], sh[0][p + half][jl]);
      sh[1][p][jl] = __fadd_rn(sh[1][p][jl], sh[1][p + half][jl]);
    }
    __syncthreads();
  }
  if (p == 0 && j < c) finish(e, c, j, sh[0][0][jl], sh[1][0][jl]);
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

template <typename Epilogue>
void launch_final(const float* partial, int chunks, int64_t c, const Epilogue& e,
                  cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((c + kFinalCols - 1) / kFinalCols);
  bn_sums_final<Epilogue><<<blocks, kFinalCols * kFinalParts, 0, stream>>>(partial, chunks, c,
                                                                           e);
}

// BN1: the partials, then the second pass with the epilogue `e` (its n and
// bf16_mean are set here).
template <typename Lane, int V>
void reduce_stats(const void* x, float* partial, int64_t m, int64_t c, int bf16_stats,
           StatsEpilogue e, cudaStream_t stream) {
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
  e.n = static_cast<float>(m);
  e.bf16_mean = bf16_stats;
  launch_final(partial, chunks, c, e, stream);
}

// BN3: the partials, then the second pass with the epilogue `e`. mean and
// scale are the forward's stats[0, c) and stats[2c, 3c).
template <typename Lane, int V>
void reduce_grads(const void* dy, const void* z, const float* stats, const float* beta,
              float* partial, int64_t m, int64_t c, int relu, const GradEpilogue& e,
              cudaStream_t stream) {
  const Tiling t = make_tiling(m, c, V);
  const int chunks = m > 0 ? t.chunks : 0;
  if (chunks > 0) {
    const dim3 grid(static_cast<unsigned int>(chunks), static_cast<unsigned int>(t.tiles));
    const auto* d = static_cast<const Lane*>(dy);
    const auto* zs = static_cast<const Lane*>(z);
    const float* mean = stats;
    const float* scale = stats + 2 * c;
    if (relu) {
      bn_bwd_sums_partial<Lane, V, true><<<grid, kThreads, 0, stream>>>(
          d, zs, mean, scale, beta, partial, t);
    } else {
      bn_bwd_sums_partial<Lane, V, false><<<grid, kThreads, 0, stream>>>(
          d, zs, mean, scale, beta, partial, t);
    }
  }
  launch_final(partial, chunks, c, e, stream);
}

template <typename Lane, int V>
void fwd(const void* x, const float* stats, const float* beta, void* y, int64_t m, int64_t c,
         int relu, cudaStream_t stream) {
  const Tiling t = make_tiling(m, c, V);
  const dim3 grid(elementwise_blocks(t), static_cast<unsigned int>(t.tiles));
  const auto* xs = static_cast<const Lane*>(x);
  auto* ys = static_cast<Lane*>(y);
  const float* mean = stats;
  const float* scale = stats + 2 * c;
  if (relu) {
    bn_relu_fwd_kernel<Lane, V, true><<<grid, kThreads, 0, stream>>>(xs, mean, scale, beta,
                                                                     ys, t);
  } else {
    bn_relu_fwd_kernel<Lane, V, false><<<grid, kThreads, 0, stream>>>(xs, mean, scale, beta,
                                                                      ys, t);
  }
}

// BN4. t1 and t2 are coef[2c, 3c) and coef[3c, 4c).
template <typename Lane, int V>
void bwd_dx(const void* dy, const void* z, const float* stats, const float* beta,
            const float* coef, void* dz, int64_t m, int64_t c, int relu, cudaStream_t stream) {
  const Tiling t = make_tiling(m, c, V);
  const dim3 grid(elementwise_blocks(t), static_cast<unsigned int>(t.tiles));
  const auto* d = static_cast<const Lane*>(dy);
  const auto* zs = static_cast<const Lane*>(z);
  auto* out = static_cast<Lane*>(dz);
  const float* mean = stats;
  const float* scale = stats + 2 * c;
  const float* t1 = coef + 2 * c;
  const float* t2 = coef + 3 * c;
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

// The epilogue that forms the statistics and updates the running buffers.
StatsEpilogue moments_epilogue(void* stats, const void* gamma, void* running_mean,
                               void* running_var, void* tracked, float eps, double momentum) {
  StatsEpilogue e{};
  e.stats = static_cast<float*>(stats);
  e.gamma = static_cast<const float*>(gamma);
  e.running_mean = static_cast<float*>(running_mean);
  e.running_var = static_cast<float*>(running_var);
  e.tracked = static_cast<int64_t*>(tracked);
  e.eps = eps;
  e.keep = static_cast<float>(1.0 - momentum);
  e.take = static_cast<float>(momentum);
  return e;
}

GradEpilogue coefficients_epilogue(const void* stats, void* coef, float eps) {
  GradEpilogue e{};
  e.coef = static_cast<float*>(coef);
  e.stats = static_cast<const float*>(stats);
  e.eps = eps;
  return e;
}

}  // namespace

extern "C" {

const char* bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Rows of the partials' scratch a reduction may use; the scratch is
// (bn_max_chunks(), 2c) f32.
int bn_max_chunks() { return kMaxChunks; }

// Every entry launches on `stream` and returns cudaGetLastError(). x, y, dy,
// z, dz: (m, c) f32 (is_bf16 = 0) or bf16, contiguous, all of one call in
// one dtype; the rest f32 but `tracked` (int64); partial: scratch of
// bn_max_chunks() * 2c f32.

// BN1, the sums: out (2c + 1) = sum, sum of squares, count.
int bn_stats(const void* x, void* out, int64_t m, int64_t c, int is_bf16, int bf16_stats,
             void* partial, void* stream) {
  if (!valid(m, c)) return static_cast<int>(cudaErrorInvalidValue);
  StatsEpilogue e{};
  e.sums = static_cast<float*>(out);
  const bool v = vec_ok(is_bf16, c, {x});
  BN_DISPATCH(is_bf16, v, reduce_stats, x, static_cast<float*>(partial), m, c, bf16_stats, e,
              static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// A training BatchNorm (+ ReLU) forward in one call: BN1 with the epilogue,
// then BN2. stats (3c + 1) = mean, var, scale, count; gamma, beta,
// running_mean, running_var (c); tracked (1) int64; the running buffers and
// tracked are updated in place; y as x.
int bn_relu_forward(const void* x, const void* gamma, const void* beta, void* running_mean,
                    void* running_var, void* tracked, void* stats, void* y, int64_t m,
                    int64_t c, int is_bf16, int bf16_stats, int relu, float eps,
                    double momentum, void* partial, void* stream) {
  if (!valid(m, c)) return static_cast<int>(cudaErrorInvalidValue);
  const StatsEpilogue e =
      moments_epilogue(stats, gamma, running_mean, running_var, tracked, eps, momentum);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool v = vec_ok(is_bf16, c, {x, y});
  BN_DISPATCH(is_bf16, v, reduce_stats, x, static_cast<float*>(partial), m, c, bf16_stats, e,
              s);
  if (m > 0) {
    BN_DISPATCH(is_bf16, v, fwd, x, static_cast<const float*>(stats),
                static_cast<const float*>(beta), y, m, c, relu, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The epilogue alone on BN1's (2c + 1) sums after a group's all-reduce: the
// stats and the running update as bn_relu_forward's, with the count read
// from sums[2c].
int bn_moments(const void* sums, void* stats, const void* gamma, void* running_mean,
               void* running_var, void* tracked, int64_t c, float eps, double momentum,
               void* stream) {
  if (!valid(0, c)) return static_cast<int>(cudaErrorInvalidValue);
  StatsEpilogue e =
      moments_epilogue(stats, gamma, running_mean, running_var, tracked, eps, momentum);
  e.count = static_cast<const float*>(sums) + 2 * c;
  launch_final(static_cast<const float*>(sums), 1, c, e, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// BN2. stats (3c + 1) from BN1's epilogue; beta (c).
int bn_relu_fwd(const void* x, const void* stats, const void* beta, void* y, int64_t m,
                int64_t c, int is_bf16, int relu, void* stream) {
  if (!valid(m, c)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const bool v = vec_ok(is_bf16, c, {x, y});
  BN_DISPATCH(is_bf16, v, fwd, x, static_cast<const float*>(stats),
              static_cast<const float*>(beta), y, m, c, relu,
              static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// BN3, the sums: out (2c) = sum of dyp, sum of dyp * (z - mean).
int bn_relu_bwd_sums(const void* dy, const void* z, const void* stats, const void* beta,
                     void* out, int64_t m, int64_t c, int is_bf16, int relu, void* partial,
                     void* stream) {
  if (!valid(m, c)) return static_cast<int>(cudaErrorInvalidValue);
  GradEpilogue e{};
  e.sums = static_cast<float*>(out);
  const bool v = vec_ok(is_bf16, c, {dy, z});
  BN_DISPATCH(is_bf16, v, reduce_grads, dy, z, static_cast<const float*>(stats),
              static_cast<const float*>(beta), static_cast<float*>(partial), m, c, relu, e,
              static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// A training BatchNorm (+ ReLU) backward in one call: BN3 with the
// epilogue, then BN4. coef (4c) = dbeta, dgamma, t1, t2; dz as z.
int bn_relu_backward(const void* dy, const void* z, const void* stats, const void* beta,
                     void* coef, void* dz, int64_t m, int64_t c, int is_bf16, int relu,
                     float eps, void* partial, void* stream) {
  if (!valid(m, c)) return static_cast<int>(cudaErrorInvalidValue);
  const GradEpilogue e = coefficients_epilogue(stats, coef, eps);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool v = vec_ok(is_bf16, c, {dy, z, dz});
  BN_DISPATCH(is_bf16, v, reduce_grads, dy, z, static_cast<const float*>(stats),
              static_cast<const float*>(beta), static_cast<float*>(partial), m, c, relu, e, s);
  if (m > 0) {
    BN_DISPATCH(is_bf16, v, bwd_dx, dy, z, static_cast<const float*>(stats),
                static_cast<const float*>(beta), static_cast<const float*>(coef), dz, m, c,
                relu, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The epilogue alone on BN3's (2c) sums after a group's all-reduce (`total`):
// coef as bn_relu_backward's, with dbeta and dgamma from this rank's sums
// `local`.
int bn_bwd_coefficients(const void* total, const void* local, const void* stats, void* coef,
                        int64_t c, float eps, void* stream) {
  if (!valid(0, c)) return static_cast<int>(cudaErrorInvalidValue);
  GradEpilogue e = coefficients_epilogue(stats, coef, eps);
  e.local = static_cast<const float*>(local);
  launch_final(static_cast<const float*>(total), 1, c, e, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// BN4. coef (4c) from BN3's epilogue.
int bn_relu_bwd_dx(const void* dy, const void* z, const void* stats, const void* beta,
                   const void* coef, void* dz, int64_t m, int64_t c, int is_bf16, int relu,
                   void* stream) {
  if (!valid(m, c)) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const bool v = vec_ok(is_bf16, c, {dy, z, dz});
  BN_DISPATCH(is_bf16, v, bwd_dx, dy, z, static_cast<const float*>(stats),
              static_cast<const float*>(beta), static_cast<const float*>(coef), dz, m, c, relu,
              static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
