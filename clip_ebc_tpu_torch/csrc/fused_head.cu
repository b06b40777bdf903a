// Fused EBC head at eval: per feature row, L2-normalize, cosine against the
// pre-normalized text rows, x exp(logit_scale), softmax over the K bins and
// the anchor expectation, written as one fp32 density per row (ports the
// Pallas kernel clip_ebc_tpu/ops/fused_head.py: fused_ebc_head's
// pallas_call, body _kernel).
//
// Bound. At the flagship shape (N = 140 windows x 28 x 28 = 109,760 rows,
// C = 512, K = 5) the call reads 112 MB of bf16 features (225 MB in fp32)
// and writes 0.4 MB, against ~0.7 GFLOP of fp32 work: at the published
// H100 SXM peaks (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores,
// 700 W) that is 34 us (67 us in fp32) of memory traffic and 10 us of
// arithmetic: memory-bound.
//
// Design (redesigned after the first port, a warp a row: each lane 16
// values, 16 IEEE divisions to normalize them, the K dot products each
// closed by a 5-step shuffle sum before the next, the text read from shared
// memory once a row, and the next row's loads issued only after all that:
// 0.117 ms in bf16 on an H100 SXM at 700 W, 29% of the bound; a copy doing
// the loads alone took 0.052, one without the divisions 0.094, one without
// the shuffles 0.103). Now:
//  * each warp keeps a ring of 2 groups of rows in shared memory (8 rows in
//    bf16, 4 in fp32: 8 KB at C = 512), each group one 1D bulk copy (TMA)
//    on its own mbarrier; a group is read into registers and its stage
//    refilled at once, so the next groups' bytes stay in flight under this
//    group's arithmetic. 12 warps a block, one block an SM (192 KB of
//    rings): the per-row arithmetic sets the pace, so more warps beat
//    deeper rings (8 warps x 3 stages took 0.073 ms in bf16, 12 x 2 0.059;
//    a copy that only streams the rows, 0.043);
//  * a row is split over 8 lanes (bf16) or 16 (fp32), each lane 16 bytes
//    of every 64 columns, and each lane takes the same columns of two rows:
//    every text value read from shared memory serves two rows, and the
//    shuffle trees that close a row's sums (3 or 4 steps) and the softmax
//    that follows are shared by 8 rows (bf16) or 4 (fp32) of a warp;
//  * the norm scales the K dot products (one division a row), not the C
//    values (a change of fp32 rounding only); the softmax over the K
//    logits runs in each lane of the row, lane 0 of the row storing it;
//  * the text rows are normalized here, once a block, not by launches of
//    their own in the wrapper.
// Everything after the load is fp32, like the TPU kernel.
//
// Limits: K <= 32, C a multiple of 64 and at most 1024.

#include "common.cuh"

namespace ebc {
namespace {

constexpr int kMaxBins = 32;
constexpr int kRows = 2;         // rows a lane takes at once (the same columns of each)
constexpr int kChunkCols = 64;   // columns of one 16-byte read across the lanes of a row
constexpr int kStages = 2;       // groups of rows in a warp's ring
constexpr int kWarps = 12;       // warps of a block at most, one block an SM

__device__ __forceinline__ void unpack(const uint4& u, const bf16*, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, const float*, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}

// rows of a warp's group: LPR = 64 / V lanes a row (V = 16 bytes / element
// size values a read), 32 / LPR row slots, kRows rows a slot
template <typename T>
__host__ __device__ constexpr int group_rows() { return 32 / (kChunkCols / (16 / (int)sizeof(T))) * kRows; }

// Persistent: warp w of block b takes the groups b W + w, + gridDim.x W, ..
// (W warps a block), each by a 1D bulk copy into its own ring. Lane sl of a
// row's LPR lanes holds, of each of the kRows rows of its slot, columns (j
// LPR + sl) V .. + V - 1 for chunks j < c / 64. CH chunks at most (C <= 64
// CH), KB bins at most.
template <typename T, int CH, int KB>
__global__ void __launch_bounds__(kWarps * 32, 1)
ebc_head_kernel(const T* __restrict__ feats, const float* __restrict__ text,
                const float* __restrict__ anchors, const float* __restrict__ scale_ptr,
                float* __restrict__ out, int n, int c, int k) {
  constexpr int V = 16 / sizeof(T), V4 = V / 4;
  constexpr int LPR = kChunkCols / V;  // lanes of a row: 8 (bf16) or 16 (fp32)
  constexpr int RG = 32 / LPR;         // row slots of a warp
  constexpr int GROUP = group_rows<T>();
  const int chunks = c / kChunkCols, warps = blockDim.x / 32;
  const int row_bytes = c * (int)sizeof(T), group_bytes = GROUP * row_bytes;
  // The text rows, normalized and staged so that the LPR lanes of a row
  // read consecutive float4s: float4 ((t chunks + j) V4 + h) LPR + sl holds
  // columns (j LPR + sl) V + 4 h .. + 3 of row t (no bank conflicts; the
  // row slots of a warp read the same addresses). Then each warp's ring,
  // the text rows' norms and the rings' barriers.
  extern __shared__ __align__(16) float4 tsh[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(tsh) + round_up((size_t)k * c * sizeof(float), 16);
  float* tnorm = reinterpret_cast<float*>(ring + (size_t)warps * kStages * group_bytes);  // [kMaxBins]
  uint64_t* full = reinterpret_cast<uint64_t*>(tnorm + kMaxBins);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, sl = lane % LPR, slot = lane / LPR;
  uint64_t* wfull = full + warp * kStages;
  unsigned char* wring = ring + (size_t)warp * kStages * group_bytes;
  const int groups = (n + GROUP - 1) / GROUP;
  const int first = blockIdx.x * warps + warp, stride = gridDim.x * warps;
  // this warp's i-th group into stage i % kStages (the rows that exist); lane 0
  auto issue = [&](int i) {
    const int gp = first + i * stride;
    if (gp >= groups) return;
    const int st = i % kStages;
    const int bytes = min(GROUP, n - gp * GROUP) * row_bytes;
    mbar_expect_tx(&wfull[st], (uint32_t)bytes);
    bulk_copy(wring + st * group_bytes, feats + (size_t)gp * GROUP * c, bytes, &wfull[st]);
  };
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&wfull[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages; ++s) issue(s);
  }
  // the text rows' norms (fp32, clamped at 1e-12 as the plain version), a warp a row
  for (int t = warp; t < k; t += warps) {
    float ss = 0.f;
    for (int col = lane; col < c; col += 32) ss += text[t * c + col] * text[t * c + col];
    ss = warp_sum(ss);
    if (lane == 0) tnorm[t] = fmaxf(sqrtf(ss), 1e-12f);
  }
  __syncthreads();
  float* tf = reinterpret_cast<float*>(tsh);
  for (int i = threadIdx.x; i < k * c; i += blockDim.x) {
    const int t = i / c, col = i - t * c;
    const int j = col / kChunkCols, rem = col - j * kChunkCols;
    const int cs = rem / V, e = rem - cs * V;
    tf[((((t * chunks + j) * V4 + e / 4) * LPR + cs) << 2) + (e & 3)] = text[i] / tnorm[t];
  }
  float an[KB];
#pragma unroll
  for (int t = 0; t < KB; ++t) an[t] = t < k ? anchors[t] : 0.f;
  const float scale = *scale_ptr;
  __syncthreads();  // the text staged, every ring's barriers initialized

  for (int i = 0; first + i * stride < groups; ++i) {
    const int st = i % kStages;
    mbar_wait(&wfull[st], (i / kStages) & 1);
    // the group into registers, then its stage refilled: the next groups'
    // bytes stay in flight under this group's arithmetic (rows past n hold
    // stale bytes; their results are not stored)
    uint4 cur[kRows][CH];
    const unsigned char* g = wring + st * group_bytes;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < CH; ++j)
        if (j < chunks)
          cur[r][j] = *reinterpret_cast<const uint4*>(g + (r * RG + slot) * row_bytes + (j * LPR + sl) * 16);
    __syncwarp();  // every lane's reads of the stage come before its refill
    if (lane == 0) {
      fence_proxy_async();  // (the refill writes through the async proxy)
      issue(i + kStages);
    }

    float ss[kRows], dot[kRows][KB];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ss[r] = 0.f;
#pragma unroll
      for (int t = 0; t < KB; ++t) dot[r][t] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (j < chunks) {
        float f[kRows][V];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          unpack(cur[r][j], static_cast<const T*>(nullptr), f[r]);
#pragma unroll
          for (int e = 0; e < V; ++e) ss[r] += f[r][e] * f[r][e];
        }
#pragma unroll
        for (int t = 0; t < KB; ++t) {
          if (t < k) {
#pragma unroll
            for (int h = 0; h < V4; ++h) {
              const float4 tv = tsh[((t * chunks + j) * V4 + h) * LPR + sl];
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                dot[r][t] += f[r][4 * h] * tv.x;
                dot[r][t] += f[r][4 * h + 1] * tv.y;
                dot[r][t] += f[r][4 * h + 2] * tv.z;
                dot[r][t] += f[r][4 * h + 3] * tv.w;
              }
            }
          }
        }
      }
    }
    // close the rows' sums over their LPR lanes
#pragma unroll
    for (int o = 1; o < LPR; o <<= 1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], o);
#pragma unroll
        for (int t = 0; t < KB; ++t)
          if (t < k) dot[r][t] += __shfl_xor_sync(0xffffffffu, dot[r][t], o);
      }
    }
    const int gp = first + i * stride;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float inv = scale / fmaxf(sqrtf(ss[r]), 1e-12f);
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < KB; ++t) {
        if (t < k) {
          dot[r][t] *= inv;
          mx = fmaxf(mx, dot[r][t]);
        }
      }
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int t = 0; t < KB; ++t) {
        if (t < k) {
          const float p = expf(dot[r][t] - mx);
          num += p * an[t];
          den += p;
        }
      }
      const int row = gp * GROUP + r * RG + slot;
      if (sl == 0 && row < n) out[row] = num / den;
    }
  }
}

template <typename T, int CH, int KB>
int launch(const void* feats, const void* text, const void* anchors, const void* scale, void* out,
           int n, int c, int k, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const int sms = sm_count();
  // as many warps a block (one block an SM) as their rings fit beside the text
  const size_t fixed = round_up((size_t)k * c * sizeof(float), 16) + kMaxBins * sizeof(float);
  const size_t per_warp = (size_t)kStages * (group_rows<T>() * c * sizeof(T) + sizeof(uint64_t));
  const long long fit = ((long long)max_smem - (long long)fixed) / (long long)per_warp;
  const int warps = (int)(fit < kWarps ? fit : kWarps);
  if (sms < 1 || warps < 1) return (int)cudaErrorInvalidConfiguration;
  const long long groups = (n + group_rows<T>() - 1) / group_rows<T>();
  const long long needed = (groups + warps - 1) / warps;
  const int blocks = (int)(needed < sms ? needed : sms);
  if (blocks == 0) return 0;
  const size_t smem = fixed + warps * per_warp;
  e = cudaFuncSetAttribute(ebc_head_kernel<T, CH, KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ebc_head_kernel<T, CH, KB><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const float*>(text), static_cast<const float*>(anchors),
      static_cast<const float*>(scale), static_cast<float*>(out), n, c, k);
  return (int)cudaGetLastError();
}

// the instantiation that holds C columns and K bins: chunks of 8 or 16, bins of 8 or 32
template <typename T>
int launch_for(const void* feats, const void* text, const void* anchors, const void* scale, void* out,
               int n, int c, int k, cudaStream_t stream) {
  if (c <= 8 * kChunkCols)
    return k <= 8 ? launch<T, 8, 8>(feats, text, anchors, scale, out, n, c, k, stream)
                  : launch<T, 8, kMaxBins>(feats, text, anchors, scale, out, n, c, k, stream);
  return k <= 8 ? launch<T, 16, 8>(feats, text, anchors, scale, out, n, c, k, stream)
                : launch<T, 16, kMaxBins>(feats, text, anchors, scale, out, n, c, k, stream);
}

}  // namespace
}  // namespace ebc

extern "C" int ebc_fused_head_max_bins() { return ebc::kMaxBins; }

// feats (N, C) bf16 (feats_bf16 = 1) or fp32; text (K, C) fp32 (normalized
// here); anchors (K,) fp32; scale (1,) fp32, already exp()'d; out (N,)
// fp32. Returns the CUDA error code of the launch (0 = ok).
extern "C" int ebc_fused_head(const void* feats, int feats_bf16, const void* text,
                              const void* anchors, const void* scale, void* out,
                              int n, int c, int k, void* stream) {
  using namespace ebc;
  if (k < 1 || k > kMaxBins || n < 0 || c < kChunkCols || c % kChunkCols || c > 16 * kChunkCols)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (feats_bf16) return launch_for<bf16>(feats, text, anchors, scale, out, n, c, k, st);
  return launch_for<float>(feats, text, anchors, scale, out, n, c, k, st);
}
