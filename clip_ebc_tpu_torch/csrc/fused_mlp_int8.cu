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
//  * launch 1 (entry ebc_ln_proj_gelu_int8 alone): the LN + quantize + int8
//    product of csrc/int8_proj.cuh (rows resident in registers, W_fc
//    streamed) with the GELU + quantize epilogue: hq (M, 4D) int8.
//  * launch 2 (proj_residual_wgmma_kernel, entry ebc_int8_gemm_residual
//    alone): out = x + (hq . W_pj^T * sw2 + b_proj). At the flagship shape
//    151.3 GOP (0.0764 ms at 1,979 TOP/s) against 199 MB in bf16 (0.0595
//    ms) or 298 MB in fp32 (0.0889 ms): bf16 is bound by operations, fp32
//    by bytes.
//    - a persistent block on each SM walks output tiles of 128 rows x 64
//      NC columns (NC = 3 in bf16 where D / 64 divides by 3, else 2; fp32
//      takes 2, so that its larger x tiles leave the ring 5 stages), the
//      D / 64 NC tiles of a row block one after the other, so that they
//      run at once on neighbouring SMs and the hq rows come from L2 after
//      the first read.
//    - a producer warp keeps the ring full by TMA (128B swizzle), a stage
//      128 bytes deep: the tile's hq rows and W_pj rows.
//    - two consumer warpgroups, 64 rows each, on wgmma
//      m64n(64 NC)k32.s32.s8.s8 with both operands K-major in shared
//      memory, as hq and torch's (out, in) W_pj stand; each warp frees a
//      stage on its empty barrier as soon as its products are done.
//    - x's tile lands by TMA under the products; the epilogue adds in
//      place, in the tile, and the tile leaves by TMA store. The next
//      tile's first stages load under the epilogue; its x tile as soon as
//      the store has read this one.
//
// Limits: D a multiple of 128, D <= 1024 (launch 1's rows: registers, and
// shared memory past D = 768), the hidden width a multiple of 128. At D =
// 1024 (ViT-L, hidden 4096) launch 2 takes 128-column tiles (D / 64 = 16
// does not divide by 3), 8 a row block.

#include "int8_proj.cuh"

namespace ebc {
namespace {

constexpr int kRM = 128;                 // rows of an item: two consumer warpgroups x 64
constexpr int kRK = 128;                 // depth (bytes) of a ring stage: one 128-byte swizzle row
constexpr int kRThreads = 2 * 128 + 32;  // two consumer warpgroups and a producer warp
constexpr int kRATile = kRM * kRK;       // bytes of a stage's hq tile
constexpr int kRBox = 64 * 128;          // bytes of a 64-row box of 128-byte rows (x, out)
constexpr int kRMaxStages = 6;

// d (64 x 64 NC int32) (+)= A (64 x 32 int8) . B (32 x 64 NC int8), both
// K-major in shared memory.
template <int NC>
__device__ __forceinline__ void gemm_mma(int (&d)[32 * NC], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  if constexpr (NC == 3)
    wgmma_s8_m64n192k32(d, desc_a, desc_b, accumulate);
  else
    wgmma_s8_m64n128k32(d, desc_a, desc_b, accumulate);
}

// Shared memory of a block: the ring (a stage: the hq tile, then the
// tile's 64 NC W_pj rows), each warpgroup's x / out tile, the barriers,
// 1024-byte alignment.
template <typename T, int NC>
struct RLayout {
  static constexpr int kBN = 64 * NC;
  static constexpr int kStage = kRATile + kBN * kRK;
  static constexpr int kXTile = 64 * kBN * (int)sizeof(T);
  static constexpr int kFixed = 2 * kXTile + (2 * kRMaxStages + 2) * 8 + 1024;
  static constexpr int kFit = (227 * 1024 - kFixed) / kStage;
  static constexpr int kStages = kFit < kRMaxStages ? kFit : kRMaxStages;
  static constexpr size_t kSmem = (size_t)kStages * kStage + kFixed;
};

// Persistent: block i takes the output tiles i, i + gridDim.x, ... of 128
// rows x 64 NC columns, tile u = cn item + column tile (cn = D / 64 NC), so
// that the cn tiles of an item run at about the same time on neighbouring
// blocks and its hq rows come from L2 after the first. Ring step t of the
// block (tile after tile, k-step after k-step) uses stage t % kStages.
template <typename T, int NC>
__global__ void __launch_bounds__(kRThreads, 1)
proj_residual_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                          const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tout,
                          const float* __restrict__ sw, const float* __restrict__ bias, int m, int k,
                          int cn) {
  using Lay = RLayout<T, NC>;
  constexpr int kS = Lay::kStages, kBN = Lay::kBN;
  constexpr int kXB = Lay::kXTile / kRBox;       // boxes of a warpgroup's x tile
  constexpr int kXCols = 128 / (int)sizeof(T);   // columns of a box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = sm;                                        // [kS][hq tile, W rows]
  unsigned char* xs = ring + kS * Lay::kStage;                     // [2 warpgroups][kXTile]
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + 2 * Lay::kXTile);  // [kS]
  uint64_t* empty = full + kS;                                     // [kS]
  uint64_t* xbar = empty + kS;                                     // [2]

  const int tid = threadIdx.x, lane = tid & 31;
  const int nk = k / kRK, n_tiles = (m + kRM - 1) / kRM * cn;
  // warpgroup wg's x tile of tile u (rows 128 (u / cn) + 64 wg .., columns
  // 64 NC (u % cn) ..); one thread
  auto load_x = [&](int wg, int u) {
    mbar_expect_tx(&xbar[wg], (uint32_t)Lay::kXTile);
    for (int bx = 0; bx < kXB; ++bx)
      tma_2d(xs + wg * Lay::kXTile + bx * kRBox, &tx, u % cn * kBN + bx * kXCols, u / cn * kRM + wg * 64,
             &xbar[wg]);
  };
  if (tid == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // the 8 consumer warps
    }
    mbar_init(&xbar[0], 1);
    mbar_init(&xbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform as the compiler sees it (a shuffle of lane 0's value), so
  // the wgmma do not lie on a divergent path: 0, 1 the consumer
  // warpgroups, 2 the producer warp
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 2) {
    if (lane == 0) {
      uint32_t t = 0;
      for (int u = blockIdx.x; u < n_tiles; u += gridDim.x)
        for (int s = 0; s < nk; ++s, ++t) {
          const int st = t % kS;
          if (t >= (uint32_t)kS) mbar_wait(&empty[st], ((t / kS) + 1) & 1);  // its last use released
          unsigned char* dst = ring + st * Lay::kStage;
          mbar_expect_tx(&full[st], (uint32_t)Lay::kStage);
          tma_2d(dst, &ta, s * kRK, u / cn * kRM, &full[st]);
          tma_2d(dst + kRATile, &tb, s * kRK, u % cn * kBN, &full[st]);
        }
    }
    __syncwarp();
  } else {
    const int wg = role, warp = (tid >> 5) & 3, g = lane >> 2, t4 = lane & 3;
    unsigned char* xt = xs + wg * Lay::kXTile;
    if ((tid & 127) == 0 && (int)blockIdx.x < n_tiles) load_x(wg, blockIdx.x);
    int acc[kBN / 2];
    uint32_t t = 0, xph = 0;
    for (int u = blockIdx.x; u < n_tiles; u += gridDim.x) {
      // products: step s issued while step s - 1's finish, then step s -
      // 1's stage released by each warp (every barrier wait precedes the
      // wgmma fence; the accumulators are read after the last wait)
      for (int s = 0; s < nk; ++s, ++t) {
        const int st = t % kS;
        mbar_wait(&full[st], (t / kS) & 1);
        const unsigned char* a = ring + st * Lay::kStage + wg * 64 * kRK;
        const unsigned char* b = ring + st * Lay::kStage + kRATile;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kRK / 32; ++kk)
          gemm_mma<NC>(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32), s + kk > 0);
        wgmma_commit();
        if (s > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[(t - 1) % kS]);
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[(t - 1) % kS]);

      // epilogue in the x tile: x + (acc * sw + bias), multiply and adds
      // apart, rounded once to x's dtype; thread (g, t4) of warp w owns
      // rows 16 w + g, + 8 and columns 8 j + 2 t4, + 1
      const float* c_sw = sw + u % cn * kBN;
      const float* c_bias = bias + u % cn * kBN;
      mbar_wait(&xbar[wg], xph);
      xph ^= 1;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = 8 * j + 2 * t4, byte = col * (int)sizeof(T);
        const float2 sv = *reinterpret_cast<const float2*>(c_sw + col);
        const float2 bv = *reinterpret_cast<const float2*>(c_bias + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          T* ptr = reinterpret_cast<T*>(xt + (byte >> 7) * kRBox +
                                        sw128_offset(warp * 16 + g + 8 * hh, (byte >> 4) & 7) + (byte & 15));
          const float2 xv = load2(ptr);
          store2(ptr, __fadd_rn(xv.x, __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * hh]), sv.x), bv.x)),
                 __fadd_rn(xv.y, __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * hh + 1]), sv.y), bv.y)));
        }
      }
      fence_proxy_async();  // the tile, for the TMA store's async proxy
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");  // this warpgroup only
      if ((tid & 127) == 0) {
        for (int bx = 0; bx < kXB; ++bx)
          tma_store_2d(&tout, xt + bx * kRBox, u % cn * kBN + bx * kXCols, u / cn * kRM + wg * 64);
        bulk_commit();
        if (u + (int)gridDim.x < n_tiles) {
          bulk_wait_read<0>();  // the store has read the tile: the next x may land in it
          load_x(wg, u + gridDim.x);
        }
      }
    }
    if ((tid & 127) == 0) bulk_wait_all();
  }
}

template <typename T, int NC>
cudaError_t launch_gemm_residual_nc(const void* hq, const void* wpj_q, const void* sw2, const void* b_pj,
                                    const void* x, void* out, int m, int d, int hidden, cudaStream_t st) {
  using Lay = RLayout<T, NC>;
  const CUtensorMapDataType tt = sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap ta, tb, tx, tout;
  cudaError_t e = encode_map(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, hq, hidden, m, kRM);
  if (e == cudaSuccess) e = encode_map(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wpj_q, hidden, d, Lay::kBN);
  if (e == cudaSuccess) e = encode_map(&tx, tt, (int)sizeof(T), x, d, m, 64);
  if (e == cudaSuccess) e = encode_map(&tout, tt, (int)sizeof(T), out, d, m, 64);
  if (e != cudaSuccess) return e;
  auto kernel = proj_residual_wgmma_kernel<T, NC>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lay::kSmem);
  if (e != cudaSuccess) return e;
  const int cn = d / Lay::kBN, tiles = (m + kRM - 1) / kRM * cn, sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  kernel<<<tiles < sms ? tiles : sms, kRThreads, Lay::kSmem, st>>>(
      ta, tb, tx, tout, static_cast<const float*>(sw2), static_cast<const float*>(b_pj), m, hidden, cn);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gemm_residual(const void* hq, const void* wpj_q, const void* sw2, const void* b_pj,
                                 const void* x, void* out, int m, int d, int hidden, cudaStream_t st) {
  // bf16: 192-column tiles where D / 64 divides by 3; fp32 (bound by its
  // bytes): 128-column tiles, whose smaller x tiles leave the ring 5 stages
  return (d / 64) % 3 == 0 && sizeof(T) == 2
             ? launch_gemm_residual_nc<T, 3>(hq, wpj_q, sw2, b_pj, x, out, m, d, hidden, st)
             : launch_gemm_residual_nc<T, 2>(hq, wpj_q, sw2, b_pj, x, out, m, d, hidden, st);
}

template <typename T>
cudaError_t launch_mlp(const void* x, const void* gamma, const void* beta, const void* wfc_q,
                       const void* sw1, const void* b_fc, const void* inv1, const void* inv2,
                       void* hq, const void* wpj_q, const void* sw2, const void* b_pj, void* out,
                       int m, int d, int hidden, int quick, float eps, cudaStream_t st) {
  cudaError_t e = launch_ln_proj_int8<T, kEpiGeluInt8>(x, gamma, beta, wfc_q, sw1, b_fc, inv1, hq,
                                                       m, d, hidden, eps, inv2, quick, st);
  if (e != cudaSuccess) return e;
  return launch_gemm_residual<T>(hq, wpj_q, sw2, b_pj, x, out, m, d, hidden, st);
}

bool mlp_shape_ok(int m, int d, int hidden) {
  return qproj_shape_ok(m, d, hidden) && hidden % kRK == 0 && d % 128 == 0;
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
  if (!mlp_shape_ok(m, d, hidden)) return (int)cudaErrorInvalidValue;
  return (int)(is_f32 ? launch_mlp<float>(x, gamma, beta, wfc_q, sw1, b_fc, inv1, inv2, hq, wpj_q,
                                          sw2, b_pj, out, m, d, hidden, quick, eps, st)
                      : launch_mlp<bf16>(x, gamma, beta, wfc_q, sw1, b_fc, inv1, inv2, hq, wpj_q,
                                         sw2, b_pj, out, m, d, hidden, quick, eps, st));
}

// Launch 1 alone: hq = clip(round(gelu(LN(x) int8 product) * inv2)), the
// arguments as ebc_ln_mlp_int8's.
extern "C" int ebc_ln_proj_gelu_int8(const void* x, const void* gamma, const void* beta,
                                     const void* wfc_q, const void* sw1, const void* b_fc,
                                     const void* inv1, const void* inv2, void* hq, int m, int d,
                                     int hidden, int quick, int is_f32, float eps, void* stream) {
  using namespace ebc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mlp_shape_ok(m, d, hidden)) return (int)cudaErrorInvalidValue;
  return (int)(is_f32 ? launch_ln_proj_int8<float, kEpiGeluInt8>(x, gamma, beta, wfc_q, sw1, b_fc, inv1, hq, m,
                                                                 d, hidden, eps, inv2, quick, st)
                      : launch_ln_proj_int8<bf16, kEpiGeluInt8>(x, gamma, beta, wfc_q, sw1, b_fc, inv1, hq, m,
                                                                d, hidden, eps, inv2, quick, st));
}

// Launch 2 alone: out = x + (hq . wpj_q^T * sw2 + b_pj), hq (M, 4D) int8,
// the rest as ebc_ln_mlp_int8's.
extern "C" int ebc_int8_gemm_residual(const void* hq, const void* wpj_q, const void* sw2,
                                      const void* b_pj, const void* x, void* out, int m, int d,
                                      int hidden, int is_f32, void* stream) {
  using namespace ebc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mlp_shape_ok(m, d, hidden)) return (int)cudaErrorInvalidValue;
  return (int)(is_f32 ? launch_gemm_residual<float>(hq, wpj_q, sw2, b_pj, x, out, m, d, hidden, st)
                      : launch_gemm_residual<bf16>(hq, wpj_q, sw2, b_pj, x, out, m, d, hidden, st));
}
