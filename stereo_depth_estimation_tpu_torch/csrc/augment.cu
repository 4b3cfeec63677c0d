// Fused photometric augmentation chain for both stereo views, NHWC, sm_90a.
//
// Replaces the Pallas TPU kernel stereo_depth_estimation_tpu/ops/augment_pallas.py
// (_pointwise_chain, :177; kernel body _augment_kernel :84-166 and the in-kernel
// blur _blur_plane :49-81). Per pixel and view: u8 -> f32/255, brightness
// clip(fb*x), contrast blend with the view's precomputed gray mean, saturation
// blend with the pixel's luma (0.2989, 0.587, 0.114), hue shift (rgb->hsv with
// the eps=1e-6 max-channel rule, branchless hsv->rgb), gamma clip(x)^fg, then
// for views whose blur_on is set a separable reflect-padded Gaussian (k taps,
// per-view sigma, H pass first, then W), stored as f32 or bf16.
//
// What bounds it: memory. At 128x240x320 the kernel reads 59.0 MB of uint8 and
// writes 118.0 MB of bf16, 177 MB in all: about 53 us at 3.35 TB/s (with f32
// output, 295 MB and about 88 us). The arithmetic, 142 f32 operations per pixel
// and view by chip_smoke.py's count, needs about 42 us at the card's 67 TFLOP/s.
// The gray-mean pre-pass (_pack_factors, plain torch) rereads the 59 MB input.
// This first version does not reach that bound: on an H100 SXM (700 W) it takes
// about 440 us with bf16 or f32 output alike, so its instructions limit it, not
// its bytes: each powf (six a pixel) and IEEE division (sixteen) expands to tens
// of instructions, which the operation count above counts as one.
//
// What the design does about it: every input byte is read once and every output
// written once, in the layouts the step already has (NHWC uint8 in, NHWC out,
// which the model reads as NCHW channels_last): the TPU kernel's planar
// transposes have no counterpart. A thread owns one pixel: three 16-bit loads
// bring its six channels and three 8-byte (f32) or 4-byte (bf16) stores write
// them, so a warp touches contiguous runs of memory. Factors sit in shared
// memory, loaded once per block. Whether to blur is one branch per block, on
// that image's blur_on flags, so the ~97% of images that are not blurred take
// the plain pass. A blurred block runs the chain over its tile plus a k/2 halo
// into shared memory (halo coordinates reflect-mapped, -1 -> 1 and H -> H-2,
// which equals padding after the chain because the chain is pointwise), then
// the vertical pass into a second buffer, then the horizontal pass. The halo
// makes the one kernel work at any resolution. Blur weights are computed in
// the kernel from sigma with expf and normalised. No fast-math; bf16 stores
// round to nearest even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFactorsPerView = 8;  // fb, fc, fs, fh, fg, gray_mean, blur_on, sigma
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kMaxHalf = 7;  // blur kernels up to 15 taps
constexpr float kInv255 = 1.0f / 255.0f;

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// Floor modulo (the result takes the divisor's sign), as jnp.mod and
// torch.remainder; fmodf would be wrong for negative hue shifts.
__device__ __forceinline__ float floor_mod(float x, float m) { return x - m * floorf(x / m); }

__device__ __forceinline__ int reflect_index(int i, int size) {
  if (i < 0) i = -i;
  if (i >= size) i = 2 * size - 2 - i;
  // Only halo cells that no valid output reads can still be out of range.
  return min(max(i, 0), size - 1);
}

// The colour chain of one view, in place on its three channels.
__device__ __forceinline__ void chain_view(float* c, const float* f) {
  const float fb = f[0], fc = f[1], fs = f[2], fh = f[3], fg = f[4], gray_mean = f[5];
  float r = clip01(fb * c[0]);
  float g = clip01(fb * c[1]);
  float b = clip01(fb * c[2]);
  const float contrast_other = (1.0f - fc) * gray_mean;
  r = clip01(fc * r + contrast_other);
  g = clip01(fc * g + contrast_other);
  b = clip01(fc * b + contrast_other);
  const float gray = 0.2989f * r + 0.587f * g + 0.114f * b;
  const float saturation_other = (1.0f - fs) * gray;
  r = clip01(fs * r + saturation_other);
  g = clip01(fs * g + saturation_other);
  b = clip01(fs * b + saturation_other);

  // rgb -> hsv
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const bool eqc = maxc == minc;
  const float cr = maxc - minc;
  const float s = cr / (eqc ? 1.0f : maxc);
  const float cr_div = eqc ? 1.0f : cr;
  const float rc = (maxc - r) / cr_div;
  const float gc = (maxc - g) / cr_div;
  const float bc = (maxc - b) / cr_div;
  const float eps = 1e-6f;  // a channel within eps of the max counts as the max
  const bool is_r = maxc - r <= eps;
  const bool is_g = (maxc - g <= eps) && !is_r;
  const bool is_b = !is_r && !is_g;
  const float hr = is_r ? bc - gc : 0.0f;
  const float hg = is_g ? 2.0f + rc - bc : 0.0f;
  const float hb = is_b ? 4.0f + gc - rc : 0.0f;
  float h = floor_mod((hr + hg + hb) / 6.0f + 1.0f, 1.0f);
  h = floor_mod(h + fh, 1.0f);

  // branchless hsv -> rgb, then gamma
  const float h6 = h * 6.0f;
  const float vs = maxc * s;
  const float sector[3] = {5.0f, 3.0f, 1.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float k = floor_mod(sector[i] + h6, 6.0f);
    const float ch = maxc - vs * clip01(fminf(k, 4.0f - k));
    c[i] = clip01(powf(clip01(ch), fg));
  }
}

__device__ __forceinline__ void load_pixel(const uint8_t* __restrict__ in, size_t pixel, float* v) {
  const uint16_t* p = reinterpret_cast<const uint16_t*>(in + pixel * 6);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint16_t two = __ldg(p + i);
    v[2 * i] = static_cast<float>(two & 0xff) * kInv255;
    v[2 * i + 1] = static_cast<float>(two >> 8) * kInv255;
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
  for (int i = 0; i < 3; ++i) {
    p[i] = __halves2bfloat162(__float2bfloat16_rn(v[2 * i]), __float2bfloat16_rn(v[2 * i + 1]));
  }
}

// grid (W tiles, H tiles, N), block (kTileW, kTileH); half = blur_k / 2 (0: no blur).
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
augment_kernel(const uint8_t* __restrict__ in, const float* __restrict__ factors,
               OutT* __restrict__ out, int height, int width, int half) {
  extern __shared__ float smem[];
  __shared__ float f[2 * kFactorsPerView];
  __shared__ float taps[2][2 * kMaxHalf + 1];

  const int n = blockIdx.z;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  if (tid < 2 * kFactorsPerView) f[tid] = factors[n * 2 * kFactorsPerView + tid];
  __syncthreads();

  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const size_t image = static_cast<size_t>(n) * height * width;
  const bool blur[2] = {half > 0 && f[6] > 0.0f, half > 0 && f[kFactorsPerView + 6] > 0.0f};

  if (!blur[0] && !blur[1]) {  // the same way for every thread of the block
    if (x < width && y < height) {
      const size_t pixel = image + static_cast<size_t>(y) * width + x;
      float v[6];
      load_pixel(in, pixel, v);
      chain_view(v, f);
      chain_view(v + 3, f + kFactorsPerView);
      store_pixel(out, pixel, v);
    }
    return;
  }

  const int k = 2 * half + 1;
  const int tw = kTileW + 2 * half;
  const int th = kTileH + 2 * half;
  float* tile = smem;                 // th x tw pixels x 6 channels: the chain's output
  float* vpass = smem + th * tw * 6;  // kTileH x tw x 6: after the vertical pass

  if (tid < 2) {  // normalised Gaussian taps of view `tid`
    const float sigma = f[tid * kFactorsPerView + 7];
    const float center = static_cast<float>(half);
    float norm = 0.0f;
    for (int t = 0; t < k; ++t) {
      const float d = (static_cast<float>(t) - center) / sigma;
      taps[tid][t] = expf(-0.5f * (d * d));
      norm += taps[tid][t];
    }
    for (int t = 0; t < k; ++t) taps[tid][t] /= norm;
  }
  for (int i = tid; i < th * tw; i += kThreads) {
    const int ty = i / tw;
    const int tx = i - ty * tw;
    const int gy = reflect_index(y0 - half + ty, height);
    const int gx = reflect_index(x0 - half + tx, width);
    float v[6];
    load_pixel(in, image + static_cast<size_t>(gy) * width + gx, v);
    chain_view(v, f);
    chain_view(v + 3, f + kFactorsPerView);
#pragma unroll
    for (int c = 0; c < 6; ++c) tile[i * 6 + c] = v[c];
  }
  __syncthreads();

  for (int i = tid; i < kTileH * tw; i += kThreads) {
    const int ty = i / tw;
    const int tx = i - ty * tw;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const float* w = taps[c / 3];
      float acc = 0.0f;
      for (int t = 0; t < k; ++t) acc = acc + tile[((ty + t) * tw + tx) * 6 + c] * w[t];
      vpass[i * 6 + c] = acc;
    }
  }
  __syncthreads();

  if (x < width && y < height) {
    float v[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      if (blur[c / 3]) {
        const float* w = taps[c / 3];
        float acc = 0.0f;
        for (int t = 0; t < k; ++t) {
          acc = acc + vpass[(threadIdx.y * tw + threadIdx.x + t) * 6 + c] * w[t];
        }
        v[c] = acc;
      } else {
        v[c] = tile[((threadIdx.y + half) * tw + threadIdx.x + half) * 6 + c];
      }
    }
    store_pixel(out, image + static_cast<size_t>(y) * width + x, v);
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
// Launches on `stream` and returns cudaGetLastError().
int augment_pointwise_chain(const void* images, const void* factors, void* out, int n,
                            int height, int width, int blur_k, int out_bf16, void* stream) {
  if (n <= 0 || height <= 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (blur_k != 0 && (blur_k < 3 || blur_k % 2 == 0 || blur_k / 2 > kMaxHalf ||
                      blur_k / 2 >= height || blur_k / 2 >= width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int half = blur_k / 2;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH, n);
  const size_t smem =
      half > 0 ? static_cast<size_t>((kTileH + 2 * half) + kTileH) * (kTileW + 2 * half) * 6 *
                     sizeof(float)
               : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(images);
  const float* f = static_cast<const float*>(factors);
  if (out_bf16) {
    augment_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        in, f, static_cast<__nv_bfloat16*>(out), height, width, half);
  } else {
    augment_kernel<float><<<grid, block, smem, s>>>(in, f, static_cast<float*>(out), height,
                                                    width, half);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
