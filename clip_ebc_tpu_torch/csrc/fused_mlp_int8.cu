// x + proj(gelu(fc(LN(x)))) with both products W8A8: the MLP half of a ViT
// block for inference (ports the Pallas kernel
// clip_ebc_tpu/ops/fused_attention.py: fused_ln_mlp_int8's pallas_call, body
// _ln_mlp_kernel).
//
// What it computes, rounding where the TPU kernel rounds: fp32 LayerNorm; yq
// = clip(round(y * inv1)); h = acc * (s_fc act1) + b_fc in fp32 (multiply and
// add apart); QuickGELU or the tanh GELU; hq = clip(round(gelu(h) * inv2));
// out = acc2 * (s_pj act2) + b_proj; (x_f32 + out) in x's dtype. inv1, inv2 =
// 1 / act1, 1 / act2 are read from device memory.
//
// Bound at the flagship shape (M = 140 x 229 = 32,060 rows, D = 768, hidden
// 3,072): 2 x 32060 x 768 x 3072 x 2 = 302.5 GOP of int8 over the published
// H100 SXM peak (1,979 TOP/s int8 dense, 700 W) = 0.153 ms; the bytes the
// function must move (x in, out back, both weights) take 0.03 ms at 3.35
// TB/s: operations bound it.
//
// Design: two launches, the int8 hidden passing through device memory (98
// MB at the flagship shape, 0.03 ms each way at the memory rate), chosen
// over one launch that streams the hidden axis: with act2 static the
// integers are the same either way, and one launch would keep a block's 4D
// output partial sums for all D columns in registers (128 rows x 768 int32
// = 393 KB) or cut a block to 32 rows, which reads the weights from L2 four
// times as often.
//  * launch 1: the LN + quantize + int8 product of csrc/int8_proj.cuh (rows
//    resident in shared memory, W_fc streamed) with the GELU + quantize
//    epilogue: hq (M, 4D) int8.
//  * launch 2 (int8_gemm_residual_kernel): a plain int8 GEMM, hq (M, 4D) .
//    W_pj (D, 4D)^T, both operands K-major as they stand: a 128 x 128 output
//    tile per block of 8 warps (32 x 64 each, mma.sync.m16n8k32.s8 fed by
//    ldmatrix), a 4-stage cp.async ring of 128-deep A and B tiles, tile p +
//    2 landing while p computes; epilogue: dequantize, + bias, + the
//    residual x, rounded to x's dtype, stored as pairs.
//
// Limits: D a multiple of 128, D <= 768 (launch 1's resident rows), the
// hidden width a multiple of 128.

#include "int8_proj.cuh"

namespace ebc {
namespace {

constexpr int kGM = 128, kGN = 128, kGK = 128;  // output tile and depth of one stage
constexpr int kGPitch = kGK + 16;                // tile row pitch: ldmatrix rows hit distinct banks
constexpr int kGStages = 4, kGAhead = 2;
constexpr int kGThreads = 256;                   // 8 warps: 4 along rows x 2 along columns
constexpr int kGStage = 2 * kGM * kGPitch;       // bytes of one stage: A tile, then B tile

template <typename T>
__global__ void __launch_bounds__(kGThreads, 1)
int8_gemm_residual_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                          const float* __restrict__ sw, const float* __restrict__ bias,
                          const T* __restrict__ x, T* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int row0 = blockIdx.y * kGM, col0 = blockIdx.x * kGN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int total = k / kGK;

  // stage p: A rows row0.. (zero past m), B rows col0.., depth k0 = p kGK
  auto load = [&](int p) {
    unsigned char* as = smem_raw + (size_t)(p % kGStages) * kGStage;
    unsigned char* bs = as + kGM * kGPitch;
    const int k0 = p * kGK;
    for (int i = tid; i < kGM * (kGK / 16); i += kGThreads) {
      const int r = i >> 3, c = i & 7;
      const bool ok = row0 + r < m;
      cp_async16(as + r * kGPitch + c * 16, a + (size_t)(ok ? row0 + r : 0) * k + k0 + c * 16, ok);
      cp_async16(bs + r * kGPitch + c * 16, w + (size_t)(col0 + r) * k + k0 + c * 16, true);
    }
  };
#pragma unroll
  for (int s = 0; s < kGAhead; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }

  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix addresses, as in ln_proj_int8_kernel
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
    cp_async_wait<kGAhead - 1>();
    __syncthreads();  // stage p landed for everyone; stage p-2's reads are done
    if (p + kGAhead < total) load(p + kGAhead);  // into stage p-2
    cp_async_commit();

    const unsigned char* as = smem_raw + (size_t)(p % kGStages) * kGStage;
    const unsigned char* at = as + a_row * kGPitch + a_k;
    const unsigned char* bt = as + kGM * kGPitch + b_row * kGPitch + b_k;
#pragma unroll
    for (int kk = 0; kk < kGK / 32; ++kk) {
      uint32_t af[2][4];
      ldmatrix_x4(af[0], at + kk * 32);
      ldmatrix_x4(af[1], at + 16 * kGPitch + kk * 32);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bf[4];  // column tiles 2jj and 2jj+1: {b0, b1} each
        ldmatrix_x4(bf, bt + jj * 16 * kGPitch + kk * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_s8(acc[i][2 * jj], af[i], bf[0], bf[1]);
          mma_s8(acc[i][2 * jj + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: acc * sw + bias (multiply and add apart), + x in fp32, rounded
  // to x's dtype
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + wn * 64 + j * 8 + 2 * t;
    const float s0 = sw[col], s1 = sw[col + 1], b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + wm * 32 + i * 16 + g + 8 * hh;
        if (r >= m) continue;
        const size_t idx = (size_t)r * n + col;
        const float2 xv = load2(x + idx);
        store2(out + idx,
               __fadd_rn(xv.x, __fadd_rn(__fmul_rn((float)acc[i][j][2 * hh], s0), b0)),
               __fadd_rn(xv.y, __fadd_rn(__fmul_rn((float)acc[i][j][2 * hh + 1], s1), b1)));
      }
    }
  }
}

template <typename T>
cudaError_t launch_mlp(const void* x, const void* gamma, const void* beta, const void* wfc_q,
                       const void* sw1, const void* b_fc, const void* inv1, const void* inv2,
                       void* hq, const void* wpj_q, const void* sw2, const void* b_pj, void* out,
                       int m, int d, int hidden, int quick, float eps, cudaStream_t st) {
  cudaError_t e = launch_ln_proj_int8<T, kEpiGeluInt8>(x, gamma, beta, wfc_q, sw1, b_fc, inv1, hq,
                                                       m, d, hidden, eps, inv2, quick, st);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)kGStages * kGStage;
  e = cudaFuncSetAttribute(int8_gemm_residual_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int8_gemm_residual_kernel<T><<<dim3(d / kGN, (m + kGM - 1) / kGM), kGThreads, smem, st>>>(
      static_cast<const int8_t*>(hq), static_cast<const int8_t*>(wpj_q),
      static_cast<const float*>(sw2), static_cast<const float*>(b_pj), static_cast<const T*>(x),
      static_cast<T*>(out), m, d, hidden);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ebc

// x (M, D) bf16, or fp32 when is_f32; gamma, beta (D,) fp32; wfc_q (4D, D)
// and wpj_q (D, 4D) int8 in torch Linear (out, in) layout; sw1 (4D,) = s_fc
// act1, b_fc (4D,), sw2 (D,) = s_pj act2, b_pj (D,) fp32; inv1, inv2 one fp32
// each on the device (1 / act1, 1 / act2); hq (M, 4D) int8 scratch; out (M,
// D) in x's dtype. quick: QuickGELU, else the tanh GELU. Returns the CUDA
// error code of the launches (0 = ok).
extern "C" int ebc_ln_mlp_int8(const void* x, const void* gamma, const void* beta,
                               const void* wfc_q, const void* sw1, const void* b_fc,
                               const void* inv1, const void* inv2, void* hq, const void* wpj_q,
                               const void* sw2, const void* b_pj, void* out, int m, int d,
                               int hidden, int quick, int is_f32, float eps, void* stream) {
  using namespace ebc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!qproj_shape_ok(m, d, hidden) || hidden % kGK || d % kGN) return (int)cudaErrorInvalidValue;
  return (int)(is_f32 ? launch_mlp<float>(x, gamma, beta, wfc_q, sw1, b_fc, inv1, inv2, hq, wpj_q,
                                          sw2, b_pj, out, m, d, hidden, quick, eps, st)
                      : launch_mlp<bf16>(x, gamma, beta, wfc_q, sw1, b_fc, inv1, inv2, hq, wpj_q,
                                         sw2, b_pj, out, m, d, hidden, quick, eps, st));
}
