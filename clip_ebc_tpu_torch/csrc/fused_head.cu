// Fused EBC head at eval: per feature row, L2-normalize, cosine against the
// pre-normalized text rows, x exp(logit_scale), softmax over the K bins and
// the anchor expectation, written as one fp32 density per row (ports the
// Pallas kernel clip_ebc_tpu/ops/fused_head.py: fused_ebc_head's
// pallas_call, body _kernel).
//
// Bound. At the flagship shape (N = 140 windows x 28 x 28 = 109,760 rows,
// C = 512, K = 5, bf16 features) the call reads 112 MB and writes 0.4 MB,
// against ~0.7 GFLOP of fp32 work: at the published H100 SXM peaks
// (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores, 700 W) that is
// 34 us of memory traffic and 10 us of arithmetic: memory-bound.
//
// Design: one warp per row, a grid-stride loop over rows so each block
// stages the K x C fp32 text rows (normalized by the wrapper) in shared
// memory once. Each lane loads 16-byte vectors of the row, the sum of
// squares and the K dot products are warp-shuffle reductions, and lane t
// holds bin t's logit, so the softmax over the K valid bins is three more
// warp reductions; no 128-wide bin padding as on the TPU. Everything after
// the load is fp32, like the TPU kernel.
//
// Limits: K <= 32 (one bin per lane), C a multiple of 32 x (16 bytes /
// element size) and at most 1024.

#include "common.cuh"

namespace ebc {
namespace {

constexpr int kMaxBins = 32;
constexpr int kMaxPerLane = 32;  // C <= 32 * 32
constexpr int kHeadWarps = 8;

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}

template <typename T>
__global__ void __launch_bounds__(kHeadWarps * 32)
ebc_head_kernel(const T* __restrict__ feats, const float* __restrict__ text,
                const float* __restrict__ anchors, const float* __restrict__ scale_ptr,
                float* __restrict__ out, int n, int c, int k) {
  constexpr int kVec = 16 / sizeof(T);
  // Text rows staged lane-interleaved: column (j * 32 + lane) * kVec + e of
  // row t sits at t * c + (j * kVec + e) * 32 + lane, so the dot products
  // below read 32 consecutive words per warp (no bank conflicts).
  extern __shared__ __align__(16) float tsh[];
  for (int i = threadIdx.x; i < k * c; i += blockDim.x) {
    const int t = i / c, col = i - t * c;
    const int j = col / (32 * kVec), rem = col - j * 32 * kVec;
    tsh[t * c + (j * kVec + rem % kVec) * 32 + rem / kVec] = text[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int chunks = c / (32 * kVec);
  const float scale = *scale_ptr;
  const float anchor = lane < k ? anchors[lane] : 0.f;

  for (int row = blockIdx.x * kHeadWarps + (threadIdx.x >> 5); row < n;
       row += gridDim.x * kHeadWarps) {
    const T* frow = feats + (size_t)row * c;
    float f[kMaxPerLane];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxPerLane / kVec; ++j) {
      if (j < chunks) {
        if constexpr (kVec == 8) load8(frow + (j * 32 + lane) * kVec, &f[j * kVec]);
        else load4(frow + (j * 32 + lane) * kVec, &f[j * kVec]);
#pragma unroll
        for (int e = 0; e < kVec; ++e) ss += f[j * kVec + e] * f[j * kVec + e];
      }
    }
    const float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
#pragma unroll
    for (int j = 0; j < kMaxPerLane / kVec; ++j) {
      if (j < chunks) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) f[j * kVec + e] /= nrm;
      }
    }

    float logit = kNegInf;  // lane t keeps bin t's logit; lanes >= k stay masked
    for (int t = 0; t < k; ++t) {
      const float* trow = tsh + (size_t)t * c;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxPerLane / kVec; ++j) {
        if (j < chunks) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) dot += f[j * kVec + e] * trow[(j * kVec + e) * 32 + lane];
        }
      }
      dot = warp_sum(dot) * scale;
      if (lane == t) logit = dot;
    }
    const float mx = warp_max(logit);
    const float p = lane < k ? expf(logit - mx) : 0.f;
    const float num = warp_sum(p * anchor);
    const float den = warp_sum(p);
    if (lane == 0) out[row] = num / den;
  }
}

template <typename T>
int launch(const void* feats, const void* text, const void* anchors, const void* scale,
           void* out, int n, int c, int k, void* stream) {
  const size_t smem = (size_t)k * c * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ebc_head_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int needed = (n + kHeadWarps - 1) / kHeadWarps;
  const int blocks = needed < sms * 8 ? needed : sms * 8;
  if (blocks == 0) return 0;
  ebc_head_kernel<T><<<blocks, kHeadWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feats), static_cast<const float*>(text),
      static_cast<const float*>(anchors), static_cast<const float*>(scale),
      static_cast<float*>(out), n, c, k);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ebc

extern "C" int ebc_fused_head_max_bins() { return ebc::kMaxBins; }

// feats (N, C) bf16 (feats_bf16 = 1) or fp32; text (K, C) fp32 with unit
// rows; anchors (K,) fp32; scale (1,) fp32, already exp()'d; out (N,)
// fp32. Returns the CUDA error code of the launch (0 = ok).
extern "C" int ebc_fused_head(const void* feats, int feats_bf16, const void* text,
                              const void* anchors, const void* scale, void* out,
                              int n, int c, int k, void* stream) {
  if (k < 1 || k > ebc::kMaxBins) return (int)cudaErrorInvalidValue;
  if (feats_bf16)
    return ebc::launch<ebc::bf16>(feats, text, anchors, scale, out, n, c, k, stream);
  return ebc::launch<float>(feats, text, anchors, scale, out, n, c, k, stream);
}
