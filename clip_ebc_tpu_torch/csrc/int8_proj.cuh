// LayerNorm -> static int8 quantize -> int8 x int8 -> int32 projection ->
// epilogue: the W8A8 half shared by the int8 kernels (csrc/fused_attention_int8.cu
// for the QKV projection, csrc/fused_mlp_int8.cu for the MLP's fc product).
// It ports the int8 branch of the Pallas bodies _ln_qkv_kernel and
// _ln_mlp_kernel (clip_ebc_tpu/ops/fused_attention.py).
//
// What it computes, rounding where the TPU kernels round: fp32 LayerNorm of
// x (M, D), not rounded to the activation dtype; yq = clip(round-half-even(y
// * inv_act), -127, 127) with inv_act = 1 / act_scale read from device memory
// (no host read of the calibrated scale); acc = yq . w_q^T in exact int32;
// v = acc * sw + bias in fp32 with multiply and add apart (sw = s_col *
// act_scale per output column, folded on the host side of the launch); then
// per epilogue:
//  * kEpiFloat: v rounded to the activation dtype (the qkv of the float
//    attention);
//  * kEpiInt8: clip(round(v)) as int8 (the qkv of the int8 attention: sw and
//    bias come with the 1 / (q, k, v scale) folded in, so v is already in the
//    int8 domain, as in the Pallas body's quant_attn="static" branch);
//  * kEpiGeluInt8: clip(round(gelu(v) * inv_out)) as int8 (the MLP hidden,
//    quantized at the calibrated scale of the GELU output; QuickGELU or the
//    tanh GELU of _ln_mlp_kernel, each operation rounded on its own).
//
// Design, simple first (mma.sync, no wgmma yet):
//  * one block of 8 warps per 128 rows. Each warp LayerNorms 16 rows straight
//    from device memory (a row in registers, two-pass mean / variance, 8
//    columns a lane at a time, coalesced 16-byte loads) and writes them
//    quantized into shared memory as int8: 128 rows x D bytes stay resident
//    (pitch D + 16, so the 8 rows of an ldmatrix hit distinct banks), half
//    the bf16 tile of the unquantized kernel, so a block takes twice its
//    rows and W is streamed half as often.
//  * W is read in torch's (out, in) layout, which is the K-major ("col") B
//    operand of mma.sync.m16n8k32.s8 as it stands. A 4-stage cp.async ring
//    of 128-column x 128-deep int8 tiles (pitch 144) streams all N columns
//    past the resident rows, tile p + 2 landing while p computes: one
//    __syncthreads a tile.
//  * warps tile the 128 x 128 output chunk 4 x 2: a warp owns 32 rows x 64
//    columns = 2 x 8 m16n8 accumulators (64 int32 registers), fed by
//    ldmatrix.x4 (an 8 x 16-byte matrix is an 8-row x 16-deep int8 fragment).
//  * epilogue per 128-column chunk, from the accumulators, stored as pairs.
//  * fp32 activations (a model run without --amp) take the same int8
//    product; only the loads of x and the float stores differ.
//
// Limits: D a multiple of 128, D <= 768 (the resident rows and the ring fill
// shared memory; a lane holds a row's 8-column chunks in registers); N a
// multiple of 128.
#pragma once

#include "common.cuh"

namespace ebc {

constexpr int kQM = 128;        // rows per block
constexpr int kQN = 128;        // output columns per chunk
constexpr int kQK = 128;        // depth (bytes) of one W tile
constexpr int kQStages = 4;     // W tiles in the ring ...
constexpr int kQAhead = 2;      // ... tile p + 2 lands while p computes and p - 1 may still be read
constexpr int kQThreads = 256;  // 8 warps: 4 along rows x 2 along columns
constexpr int kQWPitch = kQK + 16;  // W tile row pitch: ldmatrix rows hit distinct banks
constexpr int kQLnChunks = 3;   // 8-column chunks a lane holds in the LayerNorm
constexpr int kQMaxDim = kQLnChunks * 256;

enum { kEpiFloat = 0, kEpiInt8 = 1, kEpiGeluInt8 = 2 };

inline size_t qproj_smem_bytes(int d) {
  return (size_t)kQM * (d + 16) + (size_t)kQStages * kQN * kQWPitch;
}

// c (16x8 int32) += a (16x32 int8, row-major) . b (32x8 int8, column-major).
// Lane (g = lane / 4, t = lane % 4) holds a = {(g, 4t..4t+3), (g+8, 4t..),
// (g, 16+4t..), (g+8, 16+4t..)}, b = {(4t..4t+3, g), (16+4t.., g)} and
// c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}; within a register the
// lowest byte holds the lowest k.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 consecutive values of a row as floats.
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h2[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Two consecutive values of a row as floats.
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// round-half-even to int, clipped to the symmetric int8 range
__device__ __forceinline__ int clip8(float v) { return max(-127, min(127, __float2int_rn(v))); }

__device__ __forceinline__ int quant8(float y, float inv_act) { return clip8(__fmul_rn(y, inv_act)); }

// QuickGELU h * sigmoid(1.702 h), or the tanh GELU 0.5 h (1 + tanh(c (h +
// 0.044715 h^3))), every operation rounded on its own as the plain version
// (one PyTorch operation each) rounds.
__device__ __forceinline__ float gelu(float h, int quick) {
  if (quick) return __fmul_rn(h, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, h)))));
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, h), h), h);
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, tanhf(__fmul_rn(c, __fadd_rn(h, cube)))));
}

// Epilogue store of the output pair (row, col), (row, col + 1).
template <typename T, int Epi>
__device__ __forceinline__ void epi_store(void* out, size_t idx, float a, float b, float inv_out,
                                          int quick) {
  if constexpr (Epi == kEpiFloat) {
    store2(static_cast<T*>(out) + idx, a, b);
  } else {
    int qa, qb;
    if constexpr (Epi == kEpiInt8) {
      qa = clip8(a);
      qb = clip8(b);
    } else {
      qa = quant8(gelu(a, quick), inv_out);
      qb = quant8(gelu(b, quick), inv_out);
    }
    *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(out) + idx) =
        (uint16_t)((qa & 0xff) | ((qb & 0xff) << 8));
  }
}

template <typename T, int Epi>
__global__ void __launch_bounds__(kQThreads, 1)
ln_proj_int8_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const int8_t* __restrict__ w,
                    const float* __restrict__ sw, const float* __restrict__ bias,
                    const float* __restrict__ inv_act_ptr, void* __restrict__ out, int m, int d,
                    int n, float eps, const float* __restrict__ inv_out_ptr, int quick) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int apitch = d + 16;
  unsigned char* as = smem_raw;
  unsigned char* ws = smem_raw + (size_t)kQM * apitch;
  constexpr int kWStage = kQN * kQWPitch;

  const int row0 = blockIdx.x * kQM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk = d / kQK;            // W tiles per column chunk
  const int total = (n / kQN) * nk;  // W tiles over all chunks

  // W tile p: column chunk p / nk, depth tile p % nk
  auto load_w = [&](int p) {
    unsigned char* dst = ws + (size_t)(p % kQStages) * kWStage;
    const int col0 = (p / nk) * kQN, k0 = (p % nk) * kQK;
    for (int i = tid; i < kQN * (kQK / 16); i += kQThreads) {
      const int r = i >> 3, c = i & 7;
      cp_async16(dst + r * kQWPitch + c * 16, w + (size_t)(col0 + r) * d + k0 + c * 16, true);
    }
  };
#pragma unroll
  for (int s = 0; s < kQAhead; ++s) {
    if (s < total) load_w(s);
    cp_async_commit();
  }

  // 1. LayerNorm in fp32 and quantize, a warp 16 rows, a lane 8 columns at a
  //    time (the same columns in every row: gamma and beta loaded once),
  //    while the first W tiles land
  const float inv_act = *inv_act_ptr;
  const float inv_out = Epi == kEpiGeluInt8 ? *inv_out_ptr : 0.f;
  const int xvec = d / 8;
  float gam[kQLnChunks][8], bet[kQLnChunks][8];
#pragma unroll
  for (int c = 0; c < kQLnChunks; ++c) {
    const int cc = c * 32 + lane;
    if (cc < xvec) {
      load8(gamma + cc * 8, gam[c]);
      load8(beta + cc * 8, bet[c]);
    }
  }
  for (int r = warp * (kQM / 8); r < (warp + 1) * (kQM / 8); ++r) {
    const int gr = row0 + r;
    float v[kQLnChunks][8];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kQLnChunks; ++c) {
      const int cc = c * 32 + lane;
#pragma unroll
      for (int e = 0; e < 8; ++e) v[c][e] = 0.f;
      if (cc < xvec && gr < m) load8(x + (size_t)gr * d + cc * 8, v[c]);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[c][e];
    }
    const float mu = warp_sum(sum) / d;
    float var = 0.f;
#pragma unroll
    for (int c = 0; c < kQLnChunks; ++c) {
      if (c * 32 + lane < xvec) {
#pragma unroll
        for (int e = 0; e < 8; ++e) var += (v[c][e] - mu) * (v[c][e] - mu);
      }
    }
    const float rstd = rsqrtf(warp_sum(var) / d + eps);
#pragma unroll
    for (int c = 0; c < kQLnChunks; ++c) {
      const int cc = c * 32 + lane;
      if (cc < xvec) {
        uint32_t packed[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float y = __fadd_rn(__fmul_rn(__fmul_rn(v[c][e] - mu, rstd), gam[c][e]), bet[c][e]);
          packed[e >> 2] |= (uint32_t)(quant8(y, inv_act) & 0xff) << (8 * (e & 3));
        }
        *reinterpret_cast<uint2*>(as + (size_t)r * apitch + cc * 8) =
            make_uint2(packed[0], packed[1]);
      }
    }
  }
  // (the first __syncthreads of the main loop publishes the quantized rows)

  // 2. for each 128-column chunk: C[128 x 128] = Yq[128 x d] . Wq[chunk, :]^T,
  //    warp (wm, wn) taking rows [32 wm, +32) x columns [64 wn, +64)
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix addresses: A matrices {rows 0-7, k 0-15}, {rows 8-15, k 0-15},
  // {rows 0-7, k 16-31}, {rows 8-15, k 16-31}; B matrices {n 0-7, k 0-15},
  // {n 0-7, k 16-31}, {n 8-15, k 0-15}, {n 8-15, k 16-31}
  const int a_row = wm * 32 + (lane & 7) + ((lane >> 3) & 1) * 8, a_k = (lane >> 4) * 16;
  const int b_row = wn * 64 + (lane & 7) + (lane >> 4) * 8, b_k = ((lane >> 3) & 1) * 16;
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int p = 0; p < total; ++p) {
    const int kt = p % nk;
    cp_async_wait<kQAhead - 1>();
    __syncthreads();  // tile p landed for everyone; tile p-2's reads are done
    if (p + kQAhead < total) load_w(p + kQAhead);  // into tile p-2's stage
    cp_async_commit();

    const unsigned char* at = as + (size_t)a_row * apitch + kt * kQK + a_k;
    const unsigned char* bt = ws + (size_t)(p % kQStages) * kWStage + b_row * kQWPitch + b_k;
#pragma unroll
    for (int kk = 0; kk < kQK / 32; ++kk) {
      uint32_t af[2][4];
      ldmatrix_x4(af[0], at + kk * 32);
      ldmatrix_x4(af[1], at + 16 * apitch + kk * 32);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bf[4];  // column tiles 2jj and 2jj+1: {b0, b1} each
        ldmatrix_x4(bf, bt + jj * 16 * kQWPitch + kk * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_s8(acc[i][2 * jj], af[i], bf[0], bf[1]);
          mma_s8(acc[i][2 * jj + 1], af[i], bf[2], bf[3]);
        }
      }
    }

    if (kt == nk - 1) {
      // epilogue of the chunk: dequantize, + bias (multiply and add apart),
      // then the epilogue's rounding and store
      const int col0 = (p / nk) * kQN + wn * 64;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + j * 8 + 2 * t;
        const float s0 = sw[col], s1 = sw[col + 1], b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r0 = row0 + wm * 32 + i * 16 + g, r1 = r0 + 8;
          if (r0 < m)
            epi_store<T, Epi>(out, (size_t)r0 * n + col,
                              __fadd_rn(__fmul_rn((float)acc[i][j][0], s0), b0),
                              __fadd_rn(__fmul_rn((float)acc[i][j][1], s1), b1), inv_out, quick);
          if (r1 < m)
            epi_store<T, Epi>(out, (size_t)r1 * n + col,
                              __fadd_rn(__fmul_rn((float)acc[i][j][2], s0), b0),
                              __fadd_rn(__fmul_rn((float)acc[i][j][3], s1), b1), inv_out, quick);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
        }
      }
    }
  }
  cp_async_wait<0>();
}

// One launch of ln_proj_int8_kernel: x (M, D) in T, gamma / beta (D,), w (N,
// D) int8, sw / bias (N,), inv_act one float on the device; out (M, N) in T
// (kEpiFloat) or int8; inv_out one float on the device (kEpiGeluInt8 only).
template <typename T, int Epi>
cudaError_t launch_ln_proj_int8(const void* x, const void* gamma, const void* beta, const void* w,
                                const void* sw, const void* bias, const void* inv_act, void* out,
                                int m, int d, int n, float eps, const void* inv_out, int quick,
                                cudaStream_t st) {
  const size_t smem = qproj_smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(ln_proj_int8_kernel<T, Epi>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  ln_proj_int8_kernel<T, Epi><<<(m + kQM - 1) / kQM, kQThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const int8_t*>(w), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<const float*>(inv_act), out, m, d, n, eps,
      static_cast<const float*>(inv_out), quick);
  return cudaGetLastError();
}

inline bool qproj_shape_ok(int m, int d, int n) {
  return m >= 1 && d >= kQK && d % kQK == 0 && d <= kQMaxDim && n >= kQN && n % kQN == 0;
}

}  // namespace ebc
