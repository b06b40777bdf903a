// The W8A8 attention half of a ViT trunk block: LayerNorm -> static int8
// quantize -> int8 x int8 -> int32 joint QKV projection, then the masked
// attention in float or in int8. Ports the int8 branches of the Pallas
// kernel clip_ebc_tpu/ops/fused_attention.py: fused_ln_qkv_attention_int8
// -> _ln_qkv_forward's pallas_call, body _ln_qkv_kernel with an int8 w_ref:
//  * attn_scales=None, quant_attn off (the float attention): the projection
//    of csrc/int8_proj.cuh writing qkv in the activation dtype, then the
//    attention launch of csrc/fused_attention.cu (ebc_ln_qkv_proj_int8);
//  * attn_scales given (quant_attn="static", _pair_attention_body_static):
//    the projection writes q, k and v as int8 with the calibrated scales
//    folded into its dequantize multiply and bias (ebc_ln_qkv_proj_int8_q),
//    then mha_int8_kernel on static scales (ebc_int8_attention, dynamic=0);
//  * quant_attn=True without attn_scales (_pair_attention_body's int8
//    branch): the float projection, then the scale pass below
//    (ebc_qkv_quant_dynamic: max-abs per tile of block_b windows and head,
//    per head pair for k; quantized q, k, v), then mha_int8_kernel on those
//    scales (dynamic=1).
//
// Bound of the fully int8 block attention at the flagship shape (B = 140
// windows, L = 229, D = 768, 12 heads): 113.5 GOP for the projection and
// 22.5 GOP for QK^T and PV, all int8, over the published H100 SXM peak
// (1,979 TOP/s int8 dense, 700 W) = 0.069 ms; the bytes the function must
// move (x in, out back, W) take 0.03 ms at 3.35 TB/s: operations bound it.
// The split into two launches adds the int8 qkv round trip (74 MB, 0.022 ms
// each way), half the bf16 qkv of the float attention.
//
// mha_int8_kernel, simple first (mma.sync.m16n8k32.s8, no wgmma): one block
// (4 warps) per (64-query tile, head, window), as the first bf16 attention
// body of csrc/fused_attention.cu was.
//  * K_h of the window lands in shared memory as it is, key-major, which is
//    the K-major B operand of QK^T.
//  * The static body computes p = exp(s - m) with m the row's FINAL max and
//    rounds p * 127 to int8 before PV, so a one-sweep online rescale would
//    round other values. Each warp sweeps the keys twice in chunks of 64:
//    sweep 1 takes the row max only of its 16 rows' scores, dequantized in
//    fp32 (static: acc * (s_q s_k sm_scale); dynamic: (acc * (s_q s_k)) *
//    sm_scale), keys >= kv_len at kNegInf; sweep 2 recomputes the same int32
//    scores (so the same fp32 s), then p = exp(s - max), r = sum of the
//    unrounded p, p8 = round(p * 127) in [0, 127] and PV in int32. QK^T is
//    done twice, but a chunk's scores take 32 registers where a whole row
//    held in registers took 255 a thread at L = 229 (the first port's body,
//    slower there: PERF.md).
//  * PV needs B = V K-major over keys, but int8 mma takes B only as
//    row.col and ldmatrix.trans / movmatrix exist for 16-bit elements only.
//    So V_h is transposed while it is staged into shared memory (64 rows of
//    keys). Its keys are also permuted within each 16: lane t of a quad
//    holds in its score accumulators keys 2t, 2t+1 of each 8-key tile,
//    while the A operand wants 4 consecutive k slots a lane; mapping slot
//    4t + e to key 2t + e (e < 2) or 8 + 2t + e - 2 (e >= 2) lets P go from
//    the accumulators to the A operand without a shuffle, and V^T's rows
//    hold the keys in that slot order (vt_slot), so ldmatrix reads B as for
//    K. The key axis pads to a multiple of 64 with p8 = 0 and v = 0.
//  * Output: static (PV / r) * (s_v / 127), dynamic (PV * (s_v / 127)) / r,
//    the rounding order of each Pallas body; stored in the activation dtype
//    as pairs, head-concatenated.
//  * Each query tile of a (head, window) stages K and V again (4 times at L
//    = 229, from L2 after the first).
//
// Limits: D a multiple of 128, D <= 768 (the projection), head dim 64, L <=
// 512 (--window_size 320: 433 tokens).

#include "int8_proj.cuh"

namespace ebc {
namespace {

// ---- the int8 attention ----------------------------------------------------
constexpr int kDh8 = 64;
constexpr int kKPitch8 = kDh8 + 16;  // K rows: 80 B, the 8 rows of an ldmatrix hit distinct banks
constexpr int kI8Warps = 4;          // 16 query rows each
constexpr int kI8QTile = 16 * kI8Warps;
constexpr int kI8KeyQuantum = 64;    // keys are padded to a multiple of this, the chunk
constexpr int kI8Tiles = kI8KeyQuantum / 8;  // score tiles of a chunk
constexpr int kI8MaxKeys = 512;
constexpr int kI8MaxHeads = kQMaxDim / kDh8;

// K rows + V^T (64 rows of lp + 16 bytes: an odd multiple of 16, so the 8
// rows of an ldmatrix hit distinct banks)
size_t i8_attn_smem_bytes(int lp) { return (size_t)lp * kKPitch8 + (size_t)kDh8 * (lp + 16); }

// Position of key r in V^T's row: the k slot order of the PV A operand
// within each 16 keys (slot 4t + e holds key 2t + e for e < 2, 8 + 2t + e -
// 2 for e >= 2).
__device__ __forceinline__ int vt_slot(int r) {
  const int k = r & 15;
  return (r & ~15) + 4 * ((k & 7) >> 1) + (k & 1) + ((k >> 3) << 1);
}

// p in [0, 1] -> round(p * 127), four of them packed, the first lowest
__device__ __forceinline__ uint32_t pack_p8(float a, float b, float c, float d) {
  return (uint32_t)__float2int_rn(__fmul_rn(a, 127.f)) |
         ((uint32_t)__float2int_rn(__fmul_rn(b, 127.f)) << 8) |
         ((uint32_t)__float2int_rn(__fmul_rn(c, 127.f)) << 16) |
         ((uint32_t)__float2int_rn(__fmul_rn(d, 127.f)) << 24);
}

// ---- pieces of the body ----------------------------------------

// K_h rows (zero past l) by cp.async, then V_h transposed into V^T rows with
// the keys in slot order (zero past l); LP keys, V^T rows of VP bytes.
__device__ __forceinline__ void i8_stage_kv(unsigned char* ks, unsigned char* vt, const int8_t* base,
                                            int l, int lp, int vp, int d, int three_d, int tid) {
  for (int i = tid; i < lp * (kDh8 / 16); i += kI8Warps * 32) {
    const int r = i >> 2, c = i & 3;
    cp_async16(ks + (size_t)r * kKPitch8 + c * 16, base + (size_t)(r < l ? r : 0) * three_d + d + c * 16,
               r < l);
  }
  cp_async_commit();
  for (int i = tid; i < lp * (kDh8 / 4); i += kI8Warps * 32) {
    const int r = i >> 4, c = i & 15;
    const uint32_t v = r < l ? *reinterpret_cast<const uint32_t*>(base + (size_t)r * three_d + 2 * d + c * 4) : 0u;
    const int pos = vt_slot(r);
#pragma unroll
    for (int e = 0; e < 4; ++e) vt[(size_t)(4 * c + e) * vp + pos] = (unsigned char)(v >> (8 * e));
  }
}

// The dequantize factors, in each Pallas body's order.
__device__ __forceinline__ void i8_factors(const float* scales, int b, int h, int num_heads,
                                           float sm_scale, int dynamic, float& s_qk, float& s_pv) {
  if (dynamic) {
    const float* sc = scales + ((size_t)b * num_heads + h) * 3;
    s_qk = __fmul_rn(sc[0], sc[1]);
    s_pv = __fdiv_rn(sc[2], 127.f);
  } else {
    s_qk = __fmul_rn(__fmul_rn(scales[0], scales[1]), sm_scale);
    s_pv = __fmul_rn(scales[2], 1.f / 127.f);
  }
}

// Q fragments (A operands) of rows r0 and r1, straight from device memory.
__device__ __forceinline__ void i8_load_q(uint32_t (&qa)[kDh8 / 32][4], const int8_t* base, int r0,
                                          int r1, int l, int three_d, int t) {
#pragma unroll
  for (int kk = 0; kk < kDh8 / 32; ++kk) {
    const int c = kk * 32 + 4 * t;
    qa[kk][0] = r0 < l ? *reinterpret_cast<const uint32_t*>(base + (size_t)r0 * three_d + c) : 0u;
    qa[kk][1] = r1 < l ? *reinterpret_cast<const uint32_t*>(base + (size_t)r1 * three_d + c) : 0u;
    qa[kk][2] = r0 < l ? *reinterpret_cast<const uint32_t*>(base + (size_t)r0 * three_d + c + 16) : 0u;
    qa[kk][3] = r1 < l ? *reinterpret_cast<const uint32_t*>(base + (size_t)r1 * three_d + c + 16) : 0u;
  }
}

// acc[j] = int32 scores of rows g, g+8 against keys 8 (j0 + j) .. + 7, a chunk
// of kI8Tiles tiles.
__device__ __forceinline__ void i8_scores(int (&acc)[kI8Tiles][4], const uint32_t (&qa)[kDh8 / 32][4],
                                          const unsigned char* ks, int j0, int lane) {
#pragma unroll
  for (int j = 0; j < kI8Tiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll
  for (int j = 0; j < kI8Tiles / 2; ++j) {
#pragma unroll
    for (int kk = 0; kk < kDh8 / 32; ++kk) {
      uint32_t kb[4];  // key tiles 2j and 2j+1: {b0, b1} each
      ldmatrix_x4(kb, ks + (size_t)(j0 * 8 + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kKPitch8 +
                          kk * 32 + ((lane >> 3) & 1) * 16);
      mma_s8(acc[2 * j], qa[kk], kb[0], kb[1]);
      mma_s8(acc[2 * j + 1], qa[kk], kb[2], kb[3]);
    }
  }
}

// The dequantized fp32 score of an int32 accumulator, kNegInf for key >= kv_len.
__device__ __forceinline__ float i8_score(int acc, int key, int kv_len, float s_qk, float sm_scale,
                                          int dynamic) {
  const float v = dynamic ? __fmul_rn(__fmul_rn((float)acc, s_qk), sm_scale) : __fmul_rn((float)acc, s_qk);
  return key < kv_len ? v : kNegInf;
}

// o += p8 V over the 32 keys i * 32 ..: tiles s[j0..j0+3] hold p of those
// keys, packed into the A operand in slot order.
__device__ __forceinline__ void i8_pv(int (&o)[kDh8 / 8][4], const float (&s)[kI8Tiles][4], int j0,
                                      const unsigned char* vt, int vp, int i, int lane) {
  const uint32_t pa[4] = {
      pack_p8(s[j0][0], s[j0][1], s[j0 + 1][0], s[j0 + 1][1]),
      pack_p8(s[j0][2], s[j0][3], s[j0 + 1][2], s[j0 + 1][3]),
      pack_p8(s[j0 + 2][0], s[j0 + 2][1], s[j0 + 3][0], s[j0 + 3][1]),
      pack_p8(s[j0 + 2][2], s[j0 + 2][3], s[j0 + 3][2], s[j0 + 3][3])};
#pragma unroll
  for (int dn = 0; dn < kDh8 / 16; ++dn) {
    uint32_t vb[4];  // dh tiles 2dn and 2dn+1: {b0, b1} each
    ldmatrix_x4(vb, vt + (size_t)(dn * 16 + (lane & 7) + ((lane >> 4) << 3)) * vp + i * 32 +
                        ((lane >> 3) & 1) * 16);
    mma_s8(o[2 * dn], pa, vb[0], vb[1]);
    mma_s8(o[2 * dn + 1], pa, vb[2], vb[3]);
  }
}

// Dequantize and normalize, head-concatenated, in each Pallas body's order.
template <typename T>
__device__ __forceinline__ void i8_store(T* out, const int (&o)[kDh8 / 8][4], float sum0, float sum1,
                                         float s_pv, int dynamic, int b, int h, int l, int d, int r0,
                                         int r1, int t) {
  T* orow0 = out + ((size_t)b * l + r0) * d + h * kDh8;
  T* orow1 = out + ((size_t)b * l + r1) * d + h * kDh8;
#pragma unroll
  for (int i = 0; i < kDh8 / 8; ++i) {
    const int c = i * 8 + 2 * t;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sum = e < 2 ? sum0 : sum1;
      v[e] = dynamic ? __fdiv_rn(__fmul_rn((float)o[i][e], s_pv), sum)
                     : __fmul_rn(__fdiv_rn((float)o[i][e], sum), s_pv);
    }
    if (r0 < l) store2(orow0 + c, v[0], v[1]);
    if (r1 < l) store2(orow1 + c, v[2], v[3]);
  }
}

// ---- the attention body --------------------------------------------------------

// KC = padded key count / 32; the keys are swept in chunks of 64 (8 score
// tiles of 16 x 8 a warp), twice. scales: static (3,) = (s_q, s_k, s_v);
// dynamic (B, H, 3).
template <typename T, int KC>
__global__ void __launch_bounds__(kI8Warps * 32, 2)
mha_int8_kernel(const int8_t* __restrict__ qkv, const float* __restrict__ scales,
                T* __restrict__ out, int l, int num_heads, int kv_len, float sm_scale,
                int dynamic) {
  constexpr int LP = KC * 32, VP = LP + 16, NCH = LP / kI8KeyQuantum;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ks = smem;
  unsigned char* vt = smem + (size_t)LP * kKPitch8;

  const int b = blockIdx.z, h = blockIdx.y;
  const int d = num_heads * kDh8, three_d = 3 * d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int8_t* base = qkv + (size_t)b * l * three_d + h * kDh8;

  i8_stage_kv(ks, vt, base, l, LP, VP, d, three_d, tid);
  float s_qk, s_pv;
  i8_factors(scales, b, h, num_heads, sm_scale, dynamic, s_qk, s_pv);
  const int q0 = blockIdx.x * kI8QTile + warp * 16;
  const int r0 = q0 + g, r1 = q0 + g + 8;
  uint32_t qa[kDh8 / 32][4];
  i8_load_q(qa, base, r0, r1, l, three_d, t);
  cp_async_wait<0>();
  __syncthreads();
  if (q0 >= l) return;  // no block-wide barrier follows

  // sweep 1: the row max of the dequantized, masked scores
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll 1
  for (int c = 0; c < NCH; ++c) {
    int acc[kI8Tiles][4];
    i8_scores(acc, qa, ks, kI8Tiles * c, lane);
#pragma unroll
    for (int j = 0; j < kI8Tiles; ++j) {
      const int k0 = c * kI8KeyQuantum + j * 8 + 2 * t;
      mx0 = fmaxf(mx0, fmaxf(i8_score(acc[j][0], k0, kv_len, s_qk, sm_scale, dynamic),
                             i8_score(acc[j][1], k0 + 1, kv_len, s_qk, sm_scale, dynamic)));
      mx1 = fmaxf(mx1, fmaxf(i8_score(acc[j][2], k0, kv_len, s_qk, sm_scale, dynamic),
                             i8_score(acc[j][3], k0 + 1, kv_len, s_qk, sm_scale, dynamic)));
    }
  }
  quad_max(mx0, mx1);

  // sweep 2: the same scores, p = exp(s - max), r = sum of the unrounded p,
  // O += p8 V
  float sum0 = 0.f, sum1 = 0.f;
  int o[kDh8 / 8][4];
#pragma unroll
  for (int i = 0; i < kDh8 / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0;
#pragma unroll 1
  for (int c = 0; c < NCH; ++c) {
    int acc[kI8Tiles][4];
    i8_scores(acc, qa, ks, kI8Tiles * c, lane);
    float s[kI8Tiles][4];
#pragma unroll
    for (int j = 0; j < kI8Tiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = i8_score(acc[j][e], c * kI8KeyQuantum + j * 8 + 2 * t + (e & 1), kv_len, s_qk,
                                 sm_scale, dynamic);
        s[j][e] = expf(v - (e < 2 ? mx0 : mx1));
      }
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    i8_pv(o, s, 0, vt, VP, 2 * c, lane);
    i8_pv(o, s, 4, vt, VP, 2 * c + 1, lane);
  }
  quad_sum(sum0, sum1);
  i8_store(out, o, sum0, sum1, s_pv, dynamic, b, h, l, d, r0, r1, t);
}

template <typename T, int KC>
cudaError_t launch_mha_int8(const int8_t* qkv, const float* scales, T* out, int batch, int l,
                            int num_heads, int kv_len, float sm_scale, int dynamic,
                            cudaStream_t st) {
  auto kernel = mha_int8_kernel<T, KC>;
  const size_t smem = i8_attn_smem_bytes(KC * 32);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((l + kI8QTile - 1) / kI8QTile, num_heads, batch);
  kernel<<<grid, kI8Warps * 32, smem, st>>>(qkv, scales, out, l, num_heads, kv_len, sm_scale, dynamic);
  return cudaGetLastError();
}

// The padded key count picks the instantiation.
template <typename T>
cudaError_t launch_mha_int8_any(const void* qkv, const void* scales, void* out, int batch, int l,
                                int num_heads, int kv_len, float sm_scale, int dynamic,
                                cudaStream_t st) {
  const int8_t* q = static_cast<const int8_t*>(qkv);
  const float* sc = static_cast<const float*>(scales);
  T* o = static_cast<T*>(out);
  switch ((l + kI8KeyQuantum - 1) / kI8KeyQuantum) {
    case 1: return launch_mha_int8<T, 2>(q, sc, o, batch, l, num_heads, kv_len, sm_scale, dynamic, st);
    case 2: return launch_mha_int8<T, 4>(q, sc, o, batch, l, num_heads, kv_len, sm_scale, dynamic, st);
    case 3: return launch_mha_int8<T, 6>(q, sc, o, batch, l, num_heads, kv_len, sm_scale, dynamic, st);
    case 4: return launch_mha_int8<T, 8>(q, sc, o, batch, l, num_heads, kv_len, sm_scale, dynamic, st);
    case 5: return launch_mha_int8<T, 10>(q, sc, o, batch, l, num_heads, kv_len, sm_scale, dynamic, st);
    case 6: return launch_mha_int8<T, 12>(q, sc, o, batch, l, num_heads, kv_len, sm_scale, dynamic, st);
    case 7: return launch_mha_int8<T, 14>(q, sc, o, batch, l, num_heads, kv_len, sm_scale, dynamic, st);
    case 8: return launch_mha_int8<T, 16>(q, sc, o, batch, l, num_heads, kv_len, sm_scale, dynamic, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- the dynamic scale pass ---------------------------------------------------
constexpr int kAmaxThreads = 256;
constexpr int kQuantRows = 16;  // rows per block of the quantize launch

// amax[b][h][p] = max |qkv[b, :, p D + 64 h .. + 64]| (p = 0, 1, 2: q, k, v)
template <typename T>
__global__ void __launch_bounds__(kAmaxThreads)
qkv_amax_kernel(const T* __restrict__ qkv, float* __restrict__ amax, int l, int num_heads) {
  __shared__ float part[kAmaxThreads / 32];
  const int p = blockIdx.x / num_heads, h = blockIdx.x % num_heads, b = blockIdx.y;
  const int d = num_heads * kDh8, three_d = 3 * d;
  const T* base = qkv + (size_t)b * l * three_d + p * d + h * kDh8;
  float mx = 0.f;
  for (int i = threadIdx.x; i < l * (kDh8 / 8); i += kAmaxThreads) {
    float v[8];
    load8(base + (size_t)(i >> 3) * three_d + (i & 7) * 8, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) mx = fmaxf(mx, fabsf(v[e]));
  }
  mx = warp_max(mx);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kAmaxThreads / 32; ++w) mx = fmaxf(mx, part[w]);
    amax[((size_t)b * num_heads + h) * 3 + p] = mx;
  }
}

// The scales of window b (its tile's max over block_b windows; k's over the
// head pair too): s = max(amax, 1e-8) / 127, written to scales[b][h][p] by
// the row block 0; then q8 = clip(round(v / s)) of the block's rows.
template <typename T>
__global__ void __launch_bounds__(kAmaxThreads)
qkv_quant_kernel(const T* __restrict__ qkv, const float* __restrict__ amax,
                 int8_t* __restrict__ qkv_q, float* __restrict__ scales, int batch, int l,
                 int num_heads, int block_b) {
  __shared__ float sc[3 * kI8MaxHeads];
  const int b = blockIdx.y;
  const int d = num_heads * kDh8, three_d = 3 * d;
  if (threadIdx.x < 3 * num_heads) {
    const int p = threadIdx.x / num_heads, h = threadIdx.x % num_heads;
    const int t0 = b / block_b * block_b, t1 = min(t0 + block_b, batch);
    float mx = 0.f;
    for (int bb = t0; bb < t1; ++bb) {
      mx = fmaxf(mx, amax[((size_t)bb * num_heads + h) * 3 + p]);
      if (p == 1) mx = fmaxf(mx, amax[((size_t)bb * num_heads + (h ^ 1)) * 3 + p]);
    }
    const float s = __fdiv_rn(fmaxf(mx, 1e-8f), 127.f);
    sc[p * num_heads + h] = s;
    if (blockIdx.x == 0) scales[((size_t)b * num_heads + h) * 3 + p] = s;
  }
  __syncthreads();
  const int r0 = blockIdx.x * kQuantRows, rows = min(kQuantRows, l - r0);
  const int vecs = three_d / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += kAmaxThreads) {
    const int r = r0 + i / vecs, c = (i % vecs) * 8;
    const float s = sc[(c / d) * num_heads + (c % d) / kDh8];
    const size_t off = ((size_t)b * l + r) * three_d + c;
    float v[8];
    load8(qkv + off, v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      packed[e >> 2] |= (uint32_t)(clip8(__fdiv_rn(v[e], s)) & 0xff) << (8 * (e & 3));
    *reinterpret_cast<uint2*>(qkv_q + off) = make_uint2(packed[0], packed[1]);
  }
}

template <typename T>
cudaError_t launch_quant_dynamic(const void* qkv, void* amax, void* qkv_q, void* scales, int batch,
                                 int l, int num_heads, int block_b, cudaStream_t st) {
  qkv_amax_kernel<T><<<dim3(3 * num_heads, batch), kAmaxThreads, 0, st>>>(
      static_cast<const T*>(qkv), static_cast<float*>(amax), l, num_heads);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  qkv_quant_kernel<T><<<dim3((l + kQuantRows - 1) / kQuantRows, batch), kAmaxThreads, 0, st>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(amax), static_cast<int8_t*>(qkv_q),
      static_cast<float*>(scales), batch, l, num_heads, block_b);
  return cudaGetLastError();
}

bool attention_shape_ok(int l, int d, int num_heads, int kv_len) {
  return d == num_heads * kDh8 && d % kQK == 0 && d <= kQMaxDim && l >= 1 && l <= kI8MaxKeys &&
         kv_len >= 1 && kv_len <= l;
}

}  // namespace
}  // namespace ebc

// x (M, D) bf16, or fp32 when is_f32; gamma, beta (D,) fp32; w_q (3D, D) int8
// in torch Linear (out, in) layout; sw (3D,) fp32 = s_col * act_scale; bias
// (3D,) fp32; inv_act: one fp32 on the device, 1 / act_scale; qkv (M, 3D) in
// x's dtype. Returns the CUDA error code of the launch (0 = ok).
extern "C" int ebc_ln_qkv_proj_int8(const void* x, const void* gamma, const void* beta,
                                    const void* w_q, const void* sw, const void* bias,
                                    const void* inv_act, void* qkv, int m, int d, int is_f32,
                                    float eps, void* stream) {
  using namespace ebc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!qproj_shape_ok(m, d, 3 * d)) return (int)cudaErrorInvalidValue;
  return (int)(is_f32 ? launch_ln_proj_int8<float, kEpiFloat>(x, gamma, beta, w_q, sw, bias, inv_act,
                                                              qkv, m, d, 3 * d, eps, nullptr, 0, st)
                      : launch_ln_proj_int8<bf16, kEpiFloat>(x, gamma, beta, w_q, sw, bias, inv_act,
                                                             qkv, m, d, 3 * d, eps, nullptr, 0, st));
}

// The same projection writing q, k and v as int8: sw and bias with the
// calibrated 1 / (s_q, s_k, s_v) folded in per third; qkv_q (M, 3D) int8.
extern "C" int ebc_ln_qkv_proj_int8_q(const void* x, const void* gamma, const void* beta,
                                      const void* w_q, const void* sw, const void* bias,
                                      const void* inv_act, void* qkv_q, int m, int d, int is_f32,
                                      float eps, void* stream) {
  using namespace ebc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!qproj_shape_ok(m, d, 3 * d)) return (int)cudaErrorInvalidValue;
  return (int)(is_f32 ? launch_ln_proj_int8<float, kEpiInt8>(x, gamma, beta, w_q, sw, bias, inv_act,
                                                             qkv_q, m, d, 3 * d, eps, nullptr, 0, st)
                      : launch_ln_proj_int8<bf16, kEpiInt8>(x, gamma, beta, w_q, sw, bias, inv_act,
                                                            qkv_q, m, d, 3 * d, eps, nullptr, 0, st));
}

// The dynamic scale pass: qkv (B, L, 3D) bf16, or fp32 when is_f32; amax
// (B, H, 3) fp32 scratch; qkv_q (B, L, 3D) int8 and scales (B, H, 3) fp32
// out (s_q, s_k, s_v of each window and head, tiles of block_b windows).
extern "C" int ebc_qkv_quant_dynamic(const void* qkv, void* amax, void* qkv_q, void* scales,
                                     int batch, int l, int d, int num_heads, int block_b,
                                     int is_f32, void* stream) {
  using namespace ebc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!attention_shape_ok(l, d, num_heads, l) || num_heads % 2 || batch < 1 || block_b < 1)
    return (int)cudaErrorInvalidValue;
  return (int)(is_f32 ? launch_quant_dynamic<float>(qkv, amax, qkv_q, scales, batch, l, num_heads, block_b, st)
                      : launch_quant_dynamic<bf16>(qkv, amax, qkv_q, scales, batch, l, num_heads, block_b, st));
}

// The int8 masked attention: qkv_q (B, L, 3D) int8; scales (3,) fp32 when
// dynamic == 0, else (B, H, 3); out (B, L, D) bf16, or fp32 when is_f32.
extern "C" int ebc_int8_attention(const void* qkv_q, const void* scales, void* out, int batch,
                                  int l, int d, int num_heads, int kv_len, int dynamic, int is_f32,
                                  float sm_scale, void* stream) {
  using namespace ebc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!attention_shape_ok(l, d, num_heads, kv_len) || batch < 1) return (int)cudaErrorInvalidValue;
  return (int)(is_f32 ? launch_mha_int8_any<float>(qkv_q, scales, out, batch, l, num_heads, kv_len,
                                                   sm_scale, dynamic, st)
                      : launch_mha_int8_any<bf16>(qkv_q, scales, out, batch, l, num_heads, kv_len,
                                                  sm_scale, dynamic, st));
}
