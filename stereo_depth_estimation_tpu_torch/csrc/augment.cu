// The stereo augmentation's two kernels, NHWC, sm_90a.
//
// augment_pointwise_chain (K1): the fused photometric chain for both views.
// Replaces the Pallas TPU kernel stereo_depth_estimation_tpu/ops/augment_pallas.py
// (_pointwise_chain, :177; kernel body _augment_kernel :84-166 and the in-kernel
// blur _blur_plane :49-81). Per pixel and view: u8 -> f32/255, brightness
// clip(fb*x), contrast blend with the view's precomputed gray mean, saturation
// blend with the pixel's luma (0.2989, 0.587, 0.114), hue shift (rgb->hsv with
// the eps=1e-6 max-channel rule, floor modulo, branchless hsv->rgb), gamma
// clip(x)^fg, then for views whose blur_on is set a separable reflect-padded
// Gaussian (k taps, per-view sigma, H pass first, then W), stored as f32 or bf16.
//
// What bounds K1: at 128x240x320 it reads 59.0 MB of uint8 and writes 118.0 MB
// of bf16, 177 MB in all: 52.8 us at 3.35 TB/s (f32 output: 295 MB, 88.0 us).
// Its 16-byte path runs 141.6 SASS instructions and 14 MUFU operations a
// pixel (cuobjdump -sass): about 42 us of the warp schedulers' time and 33
// us of MUFU at the H100's 1.98 GHz, so bytes are the larger limit now. On
// an H100 SXM (700 W) it takes 102-103 us with bf16 output, half its byte
// bound; the flat path alone about 78 us. The rest is the ~7% of images
// blurred at the default blur_prob, whose tiles cost 3.3 times a flat pixel.
//
// The first version took ~440 us with bf16 or f32 output alike: instructions
// bound it. Six accurate powf and sixteen IEEE divisions a pixel expanded to
// tens of instructions each, every clip was an fminf/fmaxf pair, and the I/O
// was three 2-byte loads and three 4- or 8-byte stores a pixel, 212
// instructions a pixel in all even after the first cut of the arithmetic.
// What the design does about it:
// 1. Arithmetic. x^g is ex2.approx(g * lg2.approx(x)) with denormals flushed
//    (~4e-7 absolute on [0, 1] for g in [0.8, 1.2], and exactly 0 at x = 0,
//    since lg2(0) = -inf and ex2(-inf) = +0); the intrinsics' range fix-ups
//    are not needed on [0, 1]. The hue's four divisions become one
//    approximate reciprocal of the channel range: the saturation s = range /
//    max is never formed, because hsv->rgb only needs max * s, the range
//    itself. 6h is kept unwrapped until one floor modulo by 6, and each
//    channel's clip(min(k, 4 - k)) is read as a distance to the nearest
//    multiple of 6, so no other floor modulo is needed. A byte becomes a
//    float in one PRMT (2^23 + b), and brightness is one FFMA.SAT on it.
//    Every clip to [0, 1] is __saturatef, a .sat modifier on the instruction
//    that makes the value.
// 2. 16-byte I/O. A block of the flat path owns 2048 consecutive pixels of an
//    unblurred image: its 12 KB of input come in as 16-byte loads, a warp's
//    512 bytes contiguous, through shared memory; a thread takes 8 pixels
//    (48 bytes) from there and writes its 96 (bf16) or 192 (f32) output bytes
//    back; the block then stores them as 16-byte words through __stwb (which
//    the compiler cannot split). Read and written straight from each thread's
//    48 bytes, a warp's accesses strided 48 and 96 bytes apart and wrote half
//    sectors, and this path ran at about half the card's memory rate. Where
//    H*W is not a multiple of 8 or a pointer is not 16-byte aligned, the same
//    kernel runs one pixel a thread (2-byte loads, 4- or 8-byte stores); the
//    launcher decides from the shape and the pointers.
// Whether to blur is one branch per block, on that image's blur_on flags, so
// the images that are not blurred take the flat pass. A blurred image's
// blocks loop over its 32x16 tiles: each runs the chain over its tile plus a
// k/2 halo into shared memory (halo coordinates reflect-mapped, -1 -> 1 and H
// -> H-2, which equals padding after the chain because the chain is
// pointwise), then the vertical pass into a second buffer, then the
// horizontal pass, with the six channels' sums side by side. The halo makes
// the one kernel work at any resolution. On the 16-byte path the grid's rows
// take the blurred images first, so that their slower blocks start in the
// first wave instead of trailing the last. Blur weights are computed in the
// kernel from sigma with expf and normalised. bf16 stores round to nearest
// even. A persistent kernel that brought each chunk in by a 1-D TMA copy
// while it computed the one before ran slower than this one (PERF.md).
//
// augment_gray_means: the contrast blend's per-view gray means, the pre-pass
// that K1 needs before any pixel can be processed. Replaces the XLA reduce of
// stereo_depth_estimation_tpu/ops/augment_pallas.py:213 (_pack_factors):
// mean over the view's pixels of 0.2989 r + 0.587 g + 0.114 b, each channel
// clip(fb * u8/255, 0, 1), for every view, left views first. What bounds it:
// its read of the uint8 batch, 59.0 MB at 128x240x320, 17.6 us at 3.35 TB/s;
// its few instructions a byte need about a third of that. One block per
// image reads each byte once, 48 bytes (8 pixels) a thread in three 16-byte
// loads (one pixel a thread where the shape or the pointer does not allow
// it), sums each channel in f32, and reduces in a fixed tree (warp shuffles,
// then one warp): no atomics, so two runs give the same bits. About 24 us on
// an H100 SXM (700 W).

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFactorsPerView = 8;  // fb, fc, fs, fh, fg, gray_mean, blur_on, sigma
constexpr int kThreads = 256;
constexpr int kTileW = 32;  // a blurred tile: 32 x 16 pixels, two a thread
constexpr int kTileH = 16;
constexpr int kMaxHalf = 7;  // blur kernels up to 15 taps
constexpr int kGroup = 8;    // pixels a thread owns on the 16-byte path
constexpr int kMeanThreads = 1024;
constexpr float kInv255 = 1.0f / 255.0f;
constexpr float kInv6 = 1.0f / 6.0f;
constexpr float kMagic = 8388608.0f;  // 2^23: a byte b in the low mantissa bits reads 2^23 + b

__device__ __forceinline__ int reflect_index(int i, int size) {
  if (i < 0) i = -i;
  if (i >= size) i = 2 * size - 2 - i;
  // Only halo cells that no valid output reads can still be out of range.
  return min(max(i, 0), size - 1);
}

// The approximate MUFU operations, with denormals flushed: lg2(0) = -inf and
// ex2(-inf) = +0, so x^g of x = 0 is exactly 0. The C intrinsics add range
// fix-ups (a compare and two multiplies each) that [0, 1] does not need.
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte k (0..3) of `word` as the float 2^23 + byte: one PRMT, exact, where
// an int->float conversion runs at a quarter of the FMA rate.
__device__ __forceinline__ float magic_byte(uint32_t word, int k) {
  return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | k));
}

// The colour chain of one view, in place on its three channels, which come
// in as magic bytes (2^23 + b).
__device__ __forceinline__ void chain_view(float* c, const float* f) {
  const float fb = f[0], fc = f[1], fs = f[2], fh = f[3], fg = f[4], gray_mean = f[5];
  // brightness: clip(fb * b/255) in one FFMA.SAT; -2^23 * scale is exact, so
  // the FFMA's single rounding gives round(b * scale).
  const float scale = fb * kInv255;
  const float unmagic = -kMagic * scale;
  float r = __saturatef(fmaf(c[0], scale, unmagic));
  float g = __saturatef(fmaf(c[1], scale, unmagic));
  float b = __saturatef(fmaf(c[2], scale, unmagic));
  const float contrast_other = (1.0f - fc) * gray_mean;
  r = __saturatef(fc * r + contrast_other);
  g = __saturatef(fc * g + contrast_other);
  b = __saturatef(fc * b + contrast_other);
  const float gray = 0.2989f * r + 0.587f * g + 0.114f * b;
  const float saturation_other = (1.0f - fs) * gray;
  r = __saturatef(fs * r + saturation_other);
  g = __saturatef(fs * g + saturation_other);
  b = __saturatef(fs * b + saturation_other);

  // rgb -> hsv. cr = max * s is all that hsv -> rgb needs of s, and one
  // reciprocal serves the three channel distances.
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float cr = maxc - minc;
  const float inv_cr = rcp_approx(maxc == minc ? 1.0f : cr);
  const float dr = maxc - r, dg = maxc - g, db = maxc - b;
  const float rc = dr * inv_cr;
  const float gc = dg * inv_cr;
  const float bc = db * inv_cr;
  const float eps = 1e-6f;  // a channel within eps of the max counts as the max
  const bool is_r = dr <= eps;
  const bool is_g = dg <= eps && !is_r;
  // 6h + 6 fh, taken mod 6 into [0, 6): the JAX chain's two floor modulos by 1
  // and its h * 6 in one (hsv -> rgb only reads h through 6h mod 6).
  float hue = (is_r ? bc - gc : is_g ? 2.0f + rc - bc : 4.0f + gc - rc) + 6.0f * fh;
  hue -= 6.0f * floorf(hue * kInv6);

  // Branchless hsv -> rgb, then gamma. The JAX chain's channel n takes
  // k = (n + 6h) mod 6 and clip(min(k, 4 - k), 0, 1), which is clip(2 - the
  // distance from k - 2 to the nearest multiple of 6); d = k - 2 lies in
  // [-1, 9), where that distance is min(|d|, |d - 6|): no floor modulo.
  const float sector_minus_2[3] = {3.0f, 1.0f, -1.0f};  // n = 5, 3, 1
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float d = hue + sector_minus_2[i];
    const float t = __saturatef(2.0f - fminf(fabsf(d), fabsf(d - 6.0f)));
    const float ch = __saturatef(fmaf(-cr, t, maxc));
    c[i] = __saturatef(ex2_approx(fg * lg2_approx(ch)));
  }
}

__device__ __forceinline__ void chain_pixel(float* v, const float* f) {
  chain_view(v, f);
  chain_view(v + 3, f + kFactorsPerView);
}

// One pixel's six channels as magic bytes, from three 2-byte loads.
__device__ __forceinline__ void load_pixel(const uint8_t* __restrict__ in, size_t pixel, float* v) {
  const uint16_t* p = reinterpret_cast<const uint16_t*>(in + pixel * 6);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint32_t two = __ldg(p + i);
    v[2 * i] = magic_byte(two, 0);
    v[2 * i + 1] = magic_byte(two, 1);
  }
}

__device__ __forceinline__ void store_pixel(float* out, size_t pixel, const float* v) {
  float2* p = reinterpret_cast<float2*>(out + pixel * 6);
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = make_float2(v[2 * i], v[2 * i + 1]);
}

__device__ __forceinline__ void store_pixel(__nv_bfloat16* out, size_t pixel, const float* v) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(out + pixel * 6);
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
}

// Byte i (0..47) of three 16-byte words, as a magic byte.
__device__ __forceinline__ float byte_value(const uint32_t* w, int i) {
  return magic_byte(w[i / 4], i % 4);
}

__device__ __forceinline__ void load_group(const uint8_t* __restrict__ in, size_t pixel,
                                           uint32_t* w) {
  const uint4* p = reinterpret_cast<const uint4*>(in + pixel * 6);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint4 q = __ldg(p + i);
    w[4 * i] = q.x;
    w[4 * i + 1] = q.y;
    w[4 * i + 2] = q.z;
    w[4 * i + 3] = q.w;
  }
}

// 16-byte words of output per 8-pixel group: 6 (bf16) or 12 (f32).
template <typename OutT>
constexpr int kOutWords = kGroup * 6 * static_cast<int>(sizeof(OutT)) / 16;

// The chain over 8 pixels (48 channels) from three 16-byte words, into the
// group's six (bf16) or twelve (f32) 16-byte output words.
__device__ __forceinline__ void chain_group(const uint32_t* w, const float* f,
                                            __nv_bfloat16*, uint4* o) {
#pragma unroll
  for (int j0 = 0; j0 < kGroup; j0 += 4) {  // four pixels: 48 bytes, three words
    uint32_t pairs[12];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) v[c] = byte_value(w, 6 * (j0 + j) + c);
      chain_pixel(v, f);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * c], v[2 * c + 1]);
        pairs[3 * j + c] = *reinterpret_cast<const uint32_t*>(&two);
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o[3 * (j0 / 4) + i] = make_uint4(pairs[4 * i], pairs[4 * i + 1], pairs[4 * i + 2],
                                       pairs[4 * i + 3]);
    }
  }
}

__device__ __forceinline__ void chain_group(const uint32_t* w, const float* f, float*,
                                            uint4* o) {
#pragma unroll
  for (int j = 0; j < kGroup; j += 2) {  // two pixels: twelve floats, three words
    float v[12];
#pragma unroll
    for (int c = 0; c < 12; ++c) v[c] = byte_value(w, 6 * j + c);
    chain_pixel(v, f);
    chain_pixel(v + 6, f);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o[3 * (j / 2) + i] = make_uint4(__float_as_uint(v[4 * i]), __float_as_uint(v[4 * i + 1]),
                                      __float_as_uint(v[4 * i + 2]),
                                      __float_as_uint(v[4 * i + 3]));
    }
  }
}

// acc += the six channels at p (8-byte aligned) times a tap: w0 for the left
// view's channels, w1 for the right view's.
__device__ __forceinline__ void tap_pixel(float* acc, const float* p, float w0, float w1) {
  const float2* q = reinterpret_cast<const float2*>(p);
  const float2 a = q[0], b = q[1], c = q[2];
  acc[0] = fmaf(a.x, w0, acc[0]);
  acc[1] = fmaf(a.y, w0, acc[1]);
  acc[2] = fmaf(b.x, w0, acc[2]);
  acc[3] = fmaf(b.y, w1, acc[3]);
  acc[4] = fmaf(c.x, w1, acc[4]);
  acc[5] = fmaf(c.y, w1, acc[5]);
}

// Threads 0 and 1: the normalised Gaussian taps of view 0 and 1.
__device__ __forceinline__ void blur_taps(const float* f, int half,
                                          float (*taps)[2 * kMaxHalf + 1]) {
  const int view = threadIdx.x;
  if (view >= 2) return;
  const int k = 2 * half + 1;
  const float sigma = f[view * kFactorsPerView + 7];
  const float center = static_cast<float>(half);
  float norm = 0.0f;
  for (int t = 0; t < k; ++t) {
    const float d = (static_cast<float>(t) - center) / sigma;
    taps[view][t] = expf(-0.5f * (d * d));
    norm += taps[view][t];
  }
  for (int t = 0; t < k; ++t) taps[view][t] /= norm;
}

// One 32x16 tile `t` of a blurred image: the chain over the tile plus its
// halo, then the vertical and the horizontal pass. Views whose blur_on is 0
// store the chain's output. Starts with a barrier, so the previous tile's
// readers of `smem` are done and the taps are visible.
template <typename OutT>
__device__ void blur_tile(const uint8_t* __restrict__ in, const float* f, OutT* __restrict__ out,
                          size_t image, int height, int width, int half, const bool* blur,
                          const float (*taps)[2 * kMaxHalf + 1], float* smem, int t) {
  const int tid = threadIdx.x;
  const int k = 2 * half + 1;
  const int tw = kTileW + 2 * half;
  const int th = kTileH + 2 * half;
  float* tile = smem;                 // th x tw pixels x 6 channels: the chain's output
  float* vpass = smem + th * tw * 6;  // kTileH x tw x 6: after the vertical pass
  const int tiles_w = (width + kTileW - 1) / kTileW;
  const int x0 = (t % tiles_w) * kTileW;
  const int y0 = (t / tiles_w) * kTileH;
  __syncthreads();
  for (int i = tid; i < th * tw; i += kThreads) {
    const int ty = i / tw;
    const int tx = i - ty * tw;
    const int gy = reflect_index(y0 - half + ty, height);
    const int gx = reflect_index(x0 - half + tx, width);
    float v[6];
    load_pixel(in, image + static_cast<size_t>(gy) * width + gx, v);
    chain_pixel(v, f);
#pragma unroll
    for (int c = 0; c < 6; ++c) tile[i * 6 + c] = v[c];
  }
  __syncthreads();

  // Both passes keep the six channels' sums side by side (six independent
  // FMA chains) and read a pixel's channels as three 8-byte words.
  for (int i = tid; i < kTileH * tw; i += kThreads) {
    const int ty = i / tw;
    const int tx = i - ty * tw;
    float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = 0; s < k; ++s) {
      tap_pixel(acc, tile + ((ty + s) * tw + tx) * 6, taps[0][s], taps[1][s]);
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) vpass[i * 6 + c] = acc[c];
  }
  __syncthreads();

  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int ox = i % kTileW;
    const int oy = i / kTileW;
    const int x = x0 + ox;
    const int y = y0 + oy;
    if (x >= width || y >= height) continue;
    float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = 0; s < k; ++s) {
      tap_pixel(v, vpass + (oy * tw + ox + s) * 6, taps[0][s], taps[1][s]);
    }
    const float* still = tile + ((oy + half) * tw + ox + half) * 6;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      if (!blur[c / 3]) v[c] = still[c];
    }
    store_pixel(out, image + static_cast<size_t>(y) * width + x, v);
  }
}

size_t blur_smem_bytes(int half) {
  return half > 0 ? static_cast<size_t>((kTileH + 2 * half) + kTileH) * (kTileW + 2 * half) * 6 *
                        sizeof(float)
                  : 0;
}

// The flat path of an unblurred block on the 16-byte path: `count` pixels
// (a multiple of 8) from `pixel` on. The block's bytes pass through shared
// memory, so that every global load and store of a warp covers 512
// contiguous bytes; read straight from each thread's 48 bytes, a warp's
// accesses strided 48 and 96 bytes apart and wrote half sectors, which held
// this path to about half the card's memory rate.
template <typename OutT>
__device__ __forceinline__ void flat_block(const uint8_t* __restrict__ in, const float* f,
                                           OutT* __restrict__ out, size_t pixel, int count,
                                           uint4* stage) {
  const int tid = threadIdx.x;
  const int groups = count / kGroup;
  const uint4* src = reinterpret_cast<const uint4*>(in + pixel * 6);
  for (int i = tid; i < groups * 3; i += kThreads) stage[i] = __ldg(src + i);
  __syncthreads();
  uint32_t w[12];
  if (tid < groups) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint4 q = stage[3 * tid + i];
      w[4 * i] = q.x;
      w[4 * i + 1] = q.y;
      w[4 * i + 2] = q.z;
      w[4 * i + 3] = q.w;
    }
  }
  __syncthreads();  // the output overwrites the staged input
  if (tid < groups) chain_group(w, f, out, stage + kOutWords<OutT> * tid);
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(out + pixel * 6);
  for (int i = tid; i < groups * kOutWords<OutT>; i += kThreads) __stwb(dst + i, stage[i]);
}

__device__ __forceinline__ bool image_blurred(const float* __restrict__ factors, int i) {
  return factors[i * 2 * kFactorsPerView + 6] > 0.0f ||
         factors[i * 2 * kFactorsPerView + kFactorsPerView + 6] > 0.0f;
}

// The image that grid row `row` works on: the images with a blurred view
// first, in index order, then the rest. A blurred image's blocks run the
// tiled path, several times slower a pixel than the flat one; taken in index
// order, one that falls in the grid's last wave trails it. Every thread of
// the block calls this and gets the same answer.
__device__ int image_of_row(const float* __restrict__ factors, int n, int row) {
  __shared__ int warp_counts[kThreads / 32];
  __shared__ int found;
  const int tid = threadIdx.x;
  int blurred = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    blurred += __syncthreads_count(i < n && image_blurred(factors, i));
  }
  const bool want = row < blurred;  // a blurred image, or one of the rest
  int rank = want ? row : row - blurred;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + tid;
    const bool match = i < n && image_blurred(factors, i) == want;
    const int count = __syncthreads_count(match);
    if (rank < count) {  // the same branch for the whole block
      const unsigned ballot = __ballot_sync(0xffffffffu, match);
      if (tid % 32 == 0) warp_counts[tid / 32] = __popc(ballot);
      __syncthreads();
      int before = __popc(ballot & ((1u << (tid % 32)) - 1u));
      for (int w = 0; w < tid / 32; ++w) before += warp_counts[w];
      if (match && before == rank) found = i;
      __syncthreads();
      return found;
    }
    rank -= count;
  }
  return row;  // not reached: every row has an image
}

// grid (blocks per image, N), kThreads threads; P pixels a thread on the flat
// path (kGroup: 16-byte words through shared memory, 1: one pixel); half =
// blur_k / 2 (0: no blur). A blurred image's blocks loop over its tiles.
template <typename OutT, int P>
__global__ void __launch_bounds__(kThreads, 5)
augment_kernel(const uint8_t* __restrict__ in, const float* __restrict__ factors,
               OutT* __restrict__ out, int height, int width, int half) {
  extern __shared__ uint4 smem[];  // the blur's tiles, or the flat path's staged words
  __shared__ float f[2 * kFactorsPerView];
  __shared__ float taps[2][2 * kMaxHalf + 1];
  // The one-pixel path serves ragged shapes and misaligned views: its images
  // keep their order there.
  const int n = P == kGroup && half > 0 ? image_of_row(factors, gridDim.y, blockIdx.y)
                                        : static_cast<int>(blockIdx.y);
  const int tid = threadIdx.x;
  if (tid < 2 * kFactorsPerView) f[tid] = factors[n * 2 * kFactorsPerView + tid];
  __syncthreads();

  const int pixels = height * width;
  const size_t image = static_cast<size_t>(n) * pixels;
  const bool blur[2] = {half > 0 && f[6] > 0.0f, half > 0 && f[kFactorsPerView + 6] > 0.0f};
  if (blur[0] || blur[1]) {  // the same way for every thread of the block
    blur_taps(f, half, taps);
    const int tiles = ((width + kTileW - 1) / kTileW) * ((height + kTileH - 1) / kTileH);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      blur_tile(in, f, out, image, height, width, half, blur, taps,
                reinterpret_cast<float*>(smem), t);
    }
    return;
  }

  const int first = blockIdx.x * kThreads * P;  // the block's first pixel in the image
  if (first >= pixels) return;
  if constexpr (P == kGroup) {
    flat_block(in, f, out, image + first, min(kThreads * kGroup, pixels - first), smem);
  } else {
    if (first + tid >= pixels) return;
    const size_t pixel = image + first + tid;
    float v[6];
    load_pixel(in, pixel, v);
    chain_pixel(v, f);
    store_pixel(out, pixel, v);
  }
}

template <typename OutT, int P>
cudaError_t launch_chain(const uint8_t* in, const float* f, OutT* out, int n, int height,
                         int width, int half, cudaStream_t stream) {
  const int pixels = height * width;
  const int per_block = kThreads * P;
  const dim3 grid((pixels + per_block - 1) / per_block, n);
  // The tiles take up to 51 KB (k = 15), the f32 stage 48 KB: above the
  // default limit of dynamic shared memory.
  size_t smem = blur_smem_bytes(half);
  if constexpr (P == kGroup) {
    smem = std::max(smem, static_cast<size_t>(kThreads) * kOutWords<OutT> * sizeof(uint4));
  }
  const cudaError_t err = cudaFuncSetAttribute(
      augment_kernel<OutT, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  augment_kernel<OutT, P><<<grid, kThreads, smem, stream>>>(in, f, out, height, width, half);
  return cudaSuccess;
}

// Takes 8 pixels a thread where H*W and the pointers allow it, else one.
template <typename OutT>
cudaError_t launch_chain(const uint8_t* in, const float* f, OutT* out, int n, int height,
                         int width, int half, cudaStream_t stream) {
  const bool vec = (static_cast<int64_t>(height) * width) % kGroup == 0 &&
                   ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  return vec ? launch_chain<OutT, kGroup>(in, f, out, n, height, width, half, stream)
             : launch_chain<OutT, 1>(in, f, out, n, height, width, half, stream);
}

// The six channel sums of one block, reduced into thread 0's acc in a fixed
// order: a shuffle tree in each warp, then one warp over the warps' sums.
__device__ __forceinline__ void block_sum6(float* acc) {
  __shared__ float warp_sums[kMeanThreads / 32][6];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
#pragma unroll
    for (int d = 16; d > 0; d /= 2) acc[c] += __shfl_down_sync(0xffffffffu, acc[c], d);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c) warp_sums[warp][c] = acc[c];
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x / 32;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      acc[c] = lane < warps ? warp_sums[lane][c] : 0.0f;
#pragma unroll
      for (int d = 16; d > 0; d /= 2) acc[c] += __shfl_down_sync(0xffffffffu, acc[c], d);
    }
  }
}

// grid N, kMeanThreads threads: block n writes means[n] (left view) and
// means[N + n] (right view). vec: 8 pixels a thread in 16-byte words.
template <bool kVec>
__global__ void __launch_bounds__(kMeanThreads)
gray_means_kernel(const uint8_t* __restrict__ in, const float* __restrict__ brightness,
                  float* __restrict__ means, int n, int pixels) {
  const int img = blockIdx.x;
  const float fb[2] = {brightness[img], brightness[n + img]};
  const uint8_t* base = in + static_cast<size_t>(img) * pixels * 6;
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (kVec) {
#pragma unroll 2
    for (int g = threadIdx.x; g < pixels / kGroup; g += blockDim.x) {
      uint32_t w[12];
      load_group(base, static_cast<size_t>(g) * kGroup, w);
#pragma unroll
      for (int i = 0; i < 6 * kGroup; ++i) {
        // round(b / 255) exactly as the plain version's x * (1/255): see chain_view
        const float x = fmaf(byte_value(w, i), kInv255, -kMagic * kInv255);
        acc[i % 6] += __saturatef(fb[i % 6 / 3] * x);
      }
    }
  } else {
    for (int p = threadIdx.x; p < pixels; p += blockDim.x) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const float x = static_cast<float>(base[static_cast<size_t>(p) * 6 + c]) * kInv255;
        acc[c] += __saturatef(fb[c / 3] * x);
      }
    }
  }
  block_sum6(acc);
  if (threadIdx.x == 0) {
    const float count = static_cast<float>(pixels);
    means[img] = (0.2989f * acc[0] + 0.587f * acc[1] + 0.114f * acc[2]) / count;
    means[n + img] = (0.2989f * acc[3] + 0.587f * acc[4] + 0.114f * acc[5]) / count;
  }
}

}  // namespace

extern "C" {

int augment_max_blur_kernel() { return 2 * kMaxHalf + 1; }

const char* augment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// images: (n, height, width, 6) uint8, 2-byte aligned; factors: (n, 16) f32;
// out: (n, height, width, 6) f32 (out_bf16 == 0) or bf16, 8-byte aligned.
// blur_k: 0 (no blur) or odd in [3, 15], with blur_k / 2 < height and width.
// Takes 8 pixels a thread where height * width and the pointers allow it, else
// one. Launches on `stream` and returns cudaGetLastError().
int augment_pointwise_chain(const void* images, const void* factors, void* out, int n,
                            int height, int width, int blur_k, int out_bf16, void* stream) {
  if (n <= 0 || n > 65535 || height <= 0 || width <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blur_k != 0 && (blur_k < 3 || blur_k % 2 == 0 || blur_k / 2 > kMaxHalf ||
                      blur_k / 2 >= height || blur_k / 2 >= width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int half = blur_k / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(images);
  const float* f = static_cast<const float*>(factors);
  const cudaError_t err =
      out_bf16 ? launch_chain(in, f, static_cast<__nv_bfloat16*>(out), n, height, width, half, s)
               : launch_chain(in, f, static_cast<float*>(out), n, height, width, half, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// images: (n, height, width, 6) uint8; brightness: (2n,) f32, left views then
// right; means: (2n,) f32, the same order. Takes 8 pixels a thread where
// height * width and the pointer allow it, else one. Launches on `stream` and
// returns cudaGetLastError().
int augment_gray_means(const void* images, const void* brightness, void* means, int n,
                       int height, int width, void* stream) {
  if (n <= 0 || height <= 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int pixels = height * width;
  const uint8_t* in = static_cast<const uint8_t*>(images);
  const float* fb = static_cast<const float*>(brightness);
  float* m = static_cast<float*>(means);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pixels % kGroup == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0) {
    gray_means_kernel<true><<<n, kMeanThreads, 0, s>>>(in, fb, m, n, pixels);
  } else {
    gray_means_kernel<false><<<n, kMeanThreads, 0, s>>>(in, fb, m, n, pixels);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
