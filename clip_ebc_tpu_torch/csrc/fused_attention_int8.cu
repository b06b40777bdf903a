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
//    (ebc_qkv_quant_dynamic, qkv_scale_quant_kernel: max-abs per tile of block_b
//    windows and head, per head pair for k; quantized q, k, v), then
//    mha_int8_kernel on those scales (dynamic=1).
//
// qkv_scale_quant_kernel (the JAX q8 of _pair_attention_body, :140-144): bound at
// the flagship windows by reading qkv once and writing it once as int8,
// 221.6 MB in bf16 (0.0661 ms at 3.35 TB/s), 369.3 MB in fp32 (0.1102 ms);
// its design is described where it is defined.
//
// Bound of the fully int8 block attention at the flagship shape (B = 140
// windows, L = 229, D = 768, 12 heads): 113.5 GOP for the projection and
// 22.5 GOP for QK^T and PV, all int8, over the published H100 SXM peak
// (1,979 TOP/s int8 dense, 700 W) = 0.069 ms; the bytes the function must
// move (x in, out back, W) take 0.03 ms at 3.35 TB/s: operations bound it.
// The split into two launches adds the int8 qkv round trip (74 MB, 0.022 ms
// each way), half the bf16 qkv of the float attention.
//
// mha_int8_kernel (ebc_int8_attention; ports _pair_attention_body_static,
// :195-256, and the int8 branch of _pair_attention_body, :152-175, as the
// first port rounded them): s = float(acc) x s_qk (static) or (float(acc) x
// (s_q s_k)) x sm_scale (dynamic), keys >= kv_len at kNegInf, m the row's
// final max, p = expf(s - m) (not ex2.approx, which would flip round(p x
// 127)), r = the fp32 sum of the unrounded p, p8 = rn(p x 127), P V in
// exact int32, out = (PV / r) x s_pv (static) or (PV x s_pv) / r
// (dynamic) in the activation dtype. The integer products are exact, so
// only the order of r's sum can move an output.
//  * Bound at the flagship windows (B = 140, L = 229, 12 heads): the int8
//    qkv in (74 MB) and the bf16 output back (49 MB) take 0.037 ms at 3.35
//    TB/s; QK^T and PV, 22.5 GOP, 0.011 ms at 1,979 TOP/s: bytes bound it.
//  * Design (wgmma, TMA, sm_90a; redesigned after the first port, one block
//    of 4 warps per (64-query tile, head, window) on mma.sync that staged
//    K and V again for every query tile, transposed V with byte stores and
//    computed QK^T twice: 0.257 ms at the windows, 0.414 at 70 x 433 on an
//    H100 SXM at 700 W; a copy of it without the byte-store transpose took
//    0.160 and 0.243). The persistent block of three consumer warpgroups
//    of csrc/attention_short.cuh's bf16 body: a (window, head)'s Q tiles, K
//    and V land once by TMA (64-byte rows, 64B-swizzled) in one of two
//    stages, the next pair's loads in flight; the query tiles go to the
//    warpgroups in turn, with no block-wide barrier. The warpgroup that
//    gets a pair's first tile builds V^T (the K-major B of P V: 8-bit
//    wgmma takes B only K-major) with word-wide byte permutes, 16-byte
//    loads of 4 keys and conflict-free 4-byte stores, then arrives on the
//    stage's V^T barrier, which the others wait on before their first P V.
//    V^T's rows hold the keys in the slot order of the P operand: the
//    score accumulators hold keys 8 j + 2 t, + 1 of a row, the A operand 4
//    consecutive k slots a lane, so slot 4 t + e of each 16 keys holds key
//    2 t + e (e < 2) or 8 + 2 t + e - 2, and P goes from the accumulators
//    into the register A fragments of wgmma m64n64k32 with no shuffle.
//    S = Q K^T is wgmma m64n128k32 (both operands K-major from shared
//    memory). Up to 256 keys the whole score row stays in registers, so
//    the exact max takes one sweep and QK^T is done once; from 257 to 512
//    keys the two sweeps over 128-key chunks stay. The scores' int32 ->
//    fp32 (|acc| <= 64 x 128^2 < 2^22) and the rounding of p x 127 go
//    through the 1.5 x 2^23 trick on the FMA units, not the conversion
//    unit; P V's sums reach 512 x 127 x 128, past that trick's 2^22, and
//    take __int2float_rn (exact below 2^24). The output's IEEE
//    division is one correction step from the row's correctly rounded
//    reciprocal (Markstein), exact for these quotients. A bf16 output tile
//    is staged in the warpgroup's own 8 KB and written in 16-byte stores
//    (a quad's 4-byte stores filled half a sector: 0.143 against 0.138 ms);
//    fp32 pairs go straight out.
//  * Where the time goes (timing-only copies, PERF.md): the softmax and
//    the output's arithmetic on the FMA units. Without the division the
//    body took 0.129 of 0.151 ms (hence the correction step); without
//    QK^T 0.124; without P V 0.129; V^T's build is 0.004. Tried and
//    dropped: two warpgroups (255 registers, no spill) in place of three
//    (168 registers, a little spill at 256 keys): 0.177 against 0.158.
//
// Limits: D a multiple of 128, D <= 1024 (the projection; ViT-L's 16
// heads: the attention and the scale pass work a (window, head) or a head
// pair at a time, so D only sets the column offsets), head dim 64, L <=
// 512 (--window_size 320: 433 tokens).

#include "int8_proj.cuh"

namespace ebc {
namespace {

// ---- the int8 attention ----------------------------------------------------
constexpr int kDh8 = 64;
constexpr int kI8Warpgroups = 3;  // consumers, a 64-row query tile at a time each
constexpr int kI8Threads = kI8Warpgroups * 128;
constexpr int kI8QTile = 64;      // query rows of a tile (the wgmma M)
constexpr int kI8Chunk = 128;     // keys of one S = Q K^T wgmma (its N) and of a V^T block
constexpr int kI8RegChunks = 2;   // up to 256 keys the whole score row stays in registers
constexpr int kI8MaxKeys = 512;

// One stage: QT Q tiles (64 rows x 64 B), K and V of KC chunks (128 rows x
// 64 B, 64B-swizzled as TMA lands them), then V^T (KC blocks of 64 rows x
// 128 B, 128B-swizzled: the K-major B of P V).
__host__ __device__ constexpr int i8_q_bytes(int qt) { return qt * kI8QTile * kDh8; }
__host__ __device__ constexpr int i8_kv_bytes(int kc) { return kc * kI8Chunk * kDh8; }
__host__ __device__ constexpr size_t i8_stage_bytes(int kc, int qt) {
  return (size_t)i8_q_bytes(qt) + 3 * (size_t)i8_kv_bytes(kc);
}
__host__ __device__ constexpr int i8_stages(int kc) { return kc <= kI8RegChunks ? 2 : 1; }
// the stages, then a full barrier, a V^T barrier and a done count each; 1024-byte alignment
// a warpgroup's staged 16-bit output tile (64 rows x 128 B; fp32 pairs go
// straight out, a quad's 8-byte stores filling a 32-byte sector)
constexpr int kI8OutTile = kI8QTile * kDh8 * 2;
inline size_t i8_smem_bytes(int kc, int qt, bool staged) {
  return i8_stages(kc) * i8_stage_bytes(kc, qt) + (staged ? kI8Warpgroups * kI8OutTile : 0) + 64 + 1024;
}

// Shared-memory matrix descriptor of a K-major 8-bit tile of 64-byte rows
// in the 64-byte swizzle layout (8-row atoms of 512 B): start address,
// stride between 8-row groups 512 B, layout type 2 = 64B swizzle. Stepping
// 32 values along K is +32 B on the start address.
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// 1.5 x 2^23: a float in [2^23, 2^24) holds an integer in its low mantissa
// bits, so adding it rounds to the nearest integer (half to even, as
// __float2int_rn) and subtracting it from such a float converts an integer
// of magnitude below 2^22 exactly, both on the FMA units rather than the
// slower conversion unit.
constexpr float kMagic = 12582912.f;

// int32 -> fp32, exact for |v| < 2^22: a QK^T sum over the head dim, at
// most 64 x 128^2 in magnitude (not a P V sum, which reaches 2^23 at 512
// keys: past 2^22 the added integer carries into the exponent)
__device__ __forceinline__ float i2f_exact(int v) { return __fsub_rn(__int_as_float(v + 0x4B400000), kMagic); }
static_assert(kDh8 * 128 * 128 < (1 << 22), "i2f_exact takes QK^T sums only");

// a / b rounded to nearest (IEEE division) from y = 1 / b rounded to
// nearest: q = a y, then one correction with the exact residual a - b q
// (Markstein). Exact for the normal, finite quotients of the output (a
// below 2^24 in magnitude, b in [1, 512]); y is taken once a row.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
}

// p in [0, 1] -> round(p * 127) (half to even), four of them packed, the
// first lowest
__device__ __forceinline__ uint32_t pack_p8(float a, float b, float c, float d) {
  const uint32_t qa = __float_as_uint(__fadd_rn(__fmul_rn(a, 127.f), kMagic));
  const uint32_t qb = __float_as_uint(__fadd_rn(__fmul_rn(b, 127.f), kMagic));
  const uint32_t qc = __float_as_uint(__fadd_rn(__fmul_rn(c, 127.f), kMagic));
  const uint32_t qd = __float_as_uint(__fadd_rn(__fmul_rn(d, 127.f), kMagic));
  return __byte_perm(__byte_perm(qa, qb, 0x0040), __byte_perm(qc, qd, 0x0040), 0x5410);
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

// The dequantized fp32 scores of a 128-key chunk in place (key col0 + 8 j +
// 2 t + e % 2 of row g or g + 8), kNegInf for keys >= kv_len; their max
// into mx0, mx1 (this thread's share).
__device__ __forceinline__ void i8_chunk_scores(float (&s)[64], const int (&acc)[64], int col0, int kv_len,
                                                int t, float s_qk, float sm_scale, int dynamic,
                                                float& mx0, float& mx1) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float f = i2f_exact(acc[i]);
    s[i] = dynamic ? __fmul_rn(__fmul_rn(f, s_qk), sm_scale) : __fmul_rn(f, s_qk);
  }
  if (col0 + kI8Chunk > kv_len) {  // (warp-uniform) the chunk holds masked keys
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (col0 + (i >> 2) * 8 + 2 * t + (i & 1) >= kv_len) s[i] = kNegInf;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i & 2)
      mx1 = fmaxf(mx1, s[i]);
    else
      mx0 = fmaxf(mx0, s[i]);
  }
}

// p = exp(s - max) of a chunk in place; each row's sum of the unrounded p
// into r0, r1 (this thread's share)
__device__ __forceinline__ void i8_chunk_exp(float (&s)[64], float mx0, float mx1, float& r0, float& r1) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = expf(s[i] - ((i & 2) ? mx1 : mx0));
    ((i & 2) ? r1 : r0) += s[i];
  }
}

// p8 = round(p * 127) of a chunk as the register A operand of its 4 32-key
// steps. The accumulators hold keys 8 j + 2 t, + 1 of a row; the A operand
// wants 4 consecutive k slots a lane, so slot 4 t + e of each 16 holds key
// 2 t + e (e < 2) or 8 + 2 t + e - 2 (e >= 2), and V^T's rows hold the keys
// in that slot order.
__device__ __forceinline__ void i8_pack(uint32_t (&pa)[4][4], const float (&p)[64]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = 16 * i;  // the first of the step's 4 8-key tiles, 4 values each
    pa[i][0] = pack_p8(p[j], p[j + 1], p[j + 4], p[j + 5]);
    pa[i][1] = pack_p8(p[j + 2], p[j + 3], p[j + 6], p[j + 7]);
    pa[i][2] = pack_p8(p[j + 8], p[j + 9], p[j + 12], p[j + 13]);
    pa[i][3] = pack_p8(p[j + 10], p[j + 11], p[j + 14], p[j + 15]);
  }
}

// Issues O += P8 . V of a 128-key chunk (4 wgmma of 32 keys; no commit).
__device__ __forceinline__ void i8_pv(int (&o)[32], const uint32_t (&pa)[4][4], const unsigned char* vt_block,
                                      bool first) {
#pragma unroll
  for (int i = 0; i < 4; ++i) wgmma_s8_m64n64k32_rs(o, pa[i], sw128_desc(vt_block + i * 32), !first || i > 0);
}

// V^T of a stage from its V rows (key k at 64 k, 64B-swizzled): V^T row n
// (head dim) of block c holds keys 128 c .. + 127 in slot order, 128B-
// swizzled. Unit (key group q of 16, t', 16-wide head-dim slice U) takes the
// keys 16 q + 2 t' + {0, 1, 8, 9} (16-byte loads) and writes 4-byte words of
// 4 keys for each of its 16 head-dim rows (byte permutes: a 4 x 4 transpose
// of bytes, four times); a warp's stores hit 32 distinct banks. One
// warpgroup.
template <int KC>
__device__ __forceinline__ void i8_build_vt(unsigned char* vt, const unsigned char* v, int tid) {
#pragma unroll
  for (int r = 0; r < KC; ++r) {
    const int idx = tid + 128 * r;
    const int tp = idx & 3, q = r * 8 + ((idx >> 2) & 7), U = (idx >> 5) & 3;
    uint4 w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * q + 2 * tp + (e & 1) + 8 * (e >> 1);
      w[e] = *reinterpret_cast<const uint4*>(v + k * kDh8 + ((U ^ ((k >> 1) & 3)) << 4));
    }
    unsigned char* dst = vt + (q >> 3) * (kI8Chunk * kDh8) + (((q & 7)) << 4) + 4 * tp;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t x0 = (&w[0].x)[c], x1 = (&w[1].x)[c], x2 = (&w[2].x)[c], x3 = (&w[3].x)[c];
      const uint32_t t0 = __byte_perm(x0, x1, 0x5140), t1 = __byte_perm(x0, x1, 0x7362);
      const uint32_t t2 = __byte_perm(x2, x3, 0x5140), t3 = __byte_perm(x2, x3, 0x7362);
      const uint32_t o[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * U + 4 * c + e;
        *reinterpret_cast<uint32_t*>(dst + n * 128 - ((q & 7) << 4) + (((q & 7) ^ (n & 7)) << 4)) = o[e];
      }
    }
  }
}

// O (64 x 64 int32) of one query tile: its int8 scores against the KC key
// chunks at ks, the exact row max, p = exp(s - max), r = the fp32 sum of
// the unrounded p, P8 = round(p * 127) times V^T; r into r0, r1 (summed
// over the lane quad). Waits for V^T (vt_bar) before the first P V.
template <int KC>
__device__ __forceinline__ void i8_tile(int (&o)[32], const unsigned char* qt, const unsigned char* ks,
                                        const unsigned char* vt, uint64_t* vt_bar, uint32_t par, int kv_len,
                                        int t, float s_qk, float sm_scale, int dynamic, float& r0, float& r1) {
  float mx0 = kNegInf, mx1 = kNegInf;
  r0 = 0.f;
  r1 = 0.f;
  if constexpr (KC <= kI8RegChunks) {
    // one sweep: the whole score row in registers, QK^T once
    int acc[KC][64];
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[c][i] = 0;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int kk = 0; kk < kDh8 / 32; ++kk)
        wgmma_s8_m64n128k32(acc[c], sw64_desc(qt + kk * 32), sw64_desc(ks + c * kI8Chunk * kDh8 + kk * 32),
                            kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    float s[KC][64];
#pragma unroll
    for (int c = 0; c < KC; ++c)
      i8_chunk_scores(s[c], acc[c], c * kI8Chunk, kv_len, t, s_qk, sm_scale, dynamic, mx0, mx1);
    quad_max(mx0, mx1);
    uint32_t pa[KC][4][4];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      i8_chunk_exp(s[c], mx0, mx1, r0, r1);
      i8_pack(pa[c], s[c]);
    }
    mbar_wait(vt_bar, par);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KC; ++c) i8_pv(o, pa[c], vt + c * kI8Chunk * kDh8, c == 0);
    wgmma_commit();
    wgmma_wait<0>();
  } else {
    // two sweeps: the row max, then the same scores again for p and P V
    int acc[64];
    float s[64];
#pragma unroll 1
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDh8 / 32; ++kk)
        wgmma_s8_m64n128k32(acc, sw64_desc(qt + kk * 32), sw64_desc(ks + c * kI8Chunk * kDh8 + kk * 32), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      i8_chunk_scores(s, acc, c * kI8Chunk, kv_len, t, s_qk, sm_scale, dynamic, mx0, mx1);
    }
    quad_max(mx0, mx1);
    mbar_wait(vt_bar, par);
#pragma unroll 1
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDh8 / 32; ++kk)
        wgmma_s8_m64n128k32(acc, sw64_desc(qt + kk * 32), sw64_desc(ks + c * kI8Chunk * kDh8 + kk * 32), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      float unused0 = kNegInf, unused1 = kNegInf;  // the final max is mx0, mx1
      i8_chunk_scores(s, acc, c * kI8Chunk, kv_len, t, s_qk, sm_scale, dynamic, unused0, unused1);
      i8_chunk_exp(s, mx0, mx1, r0, r1);
      uint32_t pa[4][4];
      i8_pack(pa, s);
      wgmma_fence();
      i8_pv(o, pa, vt + c * kI8Chunk * kDh8, c == 0);
      wgmma_commit();
      wgmma_wait<0>();
    }
  }
  quad_sum(r0, r1);
}

// Persistent: block i takes the (window, head) pairs i, i + gridDim.x, ...;
// a pair's Q tiles, K and V land in its stage by TMA (one thread issues
// them, completing on the stage's full barrier; rows past the window come
// from the next window or as zeros, masked keys and unstored rows), the next
// pair's loads in flight under this one's products. The block's query tiles,
// pair by pair, go to its three warpgroups in turn; the warpgroup that gets
// a pair's first tile builds its V^T and arrives on the stage's V^T barrier,
// which the others wait on before their first P V. The last of the three
// done with a stage refills it. KC = ceil(L / 128) key chunks, QT = Q tiles
// a stage holds (4 or 8). scales: static (3,) = (s_q, s_k, s_v); dynamic
// (B, H, 3).
template <typename T, int KC, int QT>
__global__ void __launch_bounds__(kI8Threads, 1)
mha_int8_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tkv,
                const float* __restrict__ scales, T* __restrict__ out, int batch, int l, int num_heads,
                int kv_len, float sm_scale, int dynamic) {
  constexpr int kStages = i8_stages(KC);
  constexpr size_t kStage = i8_stage_bytes(KC, QT);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  constexpr bool kStaged = sizeof(T) == 2;
  unsigned char* outs = sm + kStages * kStage;                          // [3 warpgroups][kI8OutTile]
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + (kStaged ? kI8Warpgroups * kI8OutTile : 0));
  uint64_t* vt_ready = full + kStages;                                   // [kStages]
  int* done = reinterpret_cast<int*>(vt_ready + kStages);                // [kStages]

  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  // warp-uniform as the compiler sees it (a shuffle of lane 0's value), so
  // the wgmma do not lie on a divergent path
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int g = lane >> 2, t = lane & 3;
  const int d = num_heads * kDh8;
  const int n_items = batch * num_heads, n_qt = (l + kI8QTile - 1) / kI8QTile;

  // the Q tiles, K and V of pair w into stage st by TMA, completing on
  // full[st]. One thread.
  auto load = [&](int w, int st) {
    const int b = w / num_heads, h = w % num_heads, row0 = b * l;
    unsigned char* qd = sm + st * kStage;
    unsigned char* kd = qd + i8_q_bytes(QT);
    unsigned char* vd = kd + i8_kv_bytes(KC);
    mbar_expect_tx(&full[st], (uint32_t)(n_qt * kI8QTile * kDh8 + 2 * i8_kv_bytes(KC)));
    for (int qt = 0; qt < n_qt; ++qt) tma_2d(qd + qt * kI8QTile * kDh8, &tq, h * kDh8, row0 + qt * kI8QTile, &full[st]);
    for (int c = 0; c < KC; ++c) {
      tma_2d(kd + c * kI8Chunk * kDh8, &tkv, d + h * kDh8, row0 + c * kI8Chunk, &full[st]);
      tma_2d(vd + c * kI8Chunk * kDh8, &tkv, 2 * d + h * kDh8, row0 + c * kI8Chunk, &full[st]);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&vt_ready[st], 1);
      done[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < kStages; ++st)
      if (blockIdx.x + st * gridDim.x < n_items) load(blockIdx.x + st * gridDim.x, st);
  }
  __syncthreads();

  int gt = 0;  // the block's query tiles in order: tile gt goes to warpgroup gt % 3
  int i = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++i) {
    const int st = i % kStages;
    const uint32_t par = (i / kStages) & 1;
    mbar_wait(&full[st], par);  // pair w landed
    const int b = w / num_heads, h = w % num_heads;
    unsigned char* qs = sm + st * kStage;
    const unsigned char* ks = qs + i8_q_bytes(QT);
    const unsigned char* vs = ks + i8_kv_bytes(KC);
    unsigned char* vts = qs + i8_q_bytes(QT) + 2 * i8_kv_bytes(KC);
    if (gt % kI8Warpgroups == wg) {
      i8_build_vt<KC>(vts, vs, tid & 127);
      fence_proxy_async();  // V^T, for the wgmma's async proxy
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");  // this warpgroup only
      if ((tid & 127) == 0) mbar_arrive(&vt_ready[st]);
    }
    float s_qk, s_pv;
    i8_factors(scales, b, h, num_heads, sm_scale, dynamic, s_qk, s_pv);
    for (int qt = 0; qt < n_qt; ++qt) {
      if (gt++ % kI8Warpgroups != wg) continue;
      int o[32];  // (the first P V product overwrites it)
      float r0, r1;
      i8_tile<KC>(o, qs + qt * kI8QTile * kDh8, ks, vts, &vt_ready[st], par, kv_len, t, s_qk, sm_scale,
                  dynamic, r0, r1);
      // dequantize and normalize in each Pallas body's order; pairs stored
      // head-concatenated (16-bit pairs staged swizzled in this warpgroup's
      // tile, then written in 16-byte stores)
      const int row0 = qt * kI8QTile + warp * 16 + g, row1 = row0 + 8;
      unsigned char* my_out = outs + wg * kI8OutTile;
      T* ob = out + (size_t)b * l * d + h * kDh8;
      const float y0 = __frcp_rn(r0), y1 = __frcp_rn(r1);
#pragma unroll
      for (int j = 0; j < kDh8 / 8; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float r = e < 2 ? r0 : r1, y = e < 2 ? y0 : y1;
          const float pv = __int2float_rn(o[4 * j + e]);  // |PV| <= 512 x 127 x 128 < 2^24: exact
          v[e] = dynamic ? div_rn(__fmul_rn(pv, s_pv), r, y) : __fmul_rn(div_rn(pv, r, y), s_pv);
        }
        if constexpr (kStaged) {
          store2(reinterpret_cast<T*>(my_out + sw128_offset(warp * 16 + g, j) + 4 * t), v[0], v[1]);
          store2(reinterpret_cast<T*>(my_out + sw128_offset(warp * 16 + g + 8, j) + 4 * t), v[2], v[3]);
        } else {
          if (row0 < l) store2(ob + (size_t)row0 * d + 8 * j + 2 * t, v[0], v[1]);
          if (row1 < l) store2(ob + (size_t)row1 * d + 8 * j + 2 * t, v[2], v[3]);
        }
      }
      if constexpr (kStaged) {
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");  // this warpgroup only
        for (int k = tid & 127; k < kI8QTile * 8; k += 128) {
          const int r = k >> 3, c = k & 7, row = qt * kI8QTile + r;
          if (row < l)
            *reinterpret_cast<uint4*>(ob + (size_t)row * d + c * 8) =
                *reinterpret_cast<const uint4*>(my_out + sw128_offset(r, c));
        }
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");  // the tile is free again
      }
    }
    // this warpgroup is done with stage st: its reads before the next TMA
    // write; the last of the three refills the stage
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if ((tid & 127) == 0 && atomicAdd(&done[st], 1) == kI8Warpgroups - 1) {
      done[st] = 0;
      if (w + kStages * (int)gridDim.x < n_items) load(w + kStages * gridDim.x, st);
    }
  }
}

// A 2D int8 tensor map over qkv (B L, 3D): boxes of 64 columns (one head)
// x box_rows, 64B-swizzled (the layout sw64_desc reads).
inline cudaError_t encode_qkv8_map(CUtensorMap* map, const void* qkv, int rows, int three_d, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)three_d, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)three_d};
  const cuuint32_t box[2] = {(cuuint32_t)kDh8, (cuuint32_t)box_rows};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, qkv, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

template <typename T, int KC>
cudaError_t launch_mha_int8(const CUtensorMap& tq, const CUtensorMap& tkv, const float* scales, T* out,
                            int batch, int l, int num_heads, int kv_len, float sm_scale, int dynamic, int blocks,
                            cudaStream_t st) {
  constexpr int QT = KC <= kI8RegChunks ? 4 : 8;
  auto kernel = mha_int8_kernel<T, KC, QT>;
  const size_t smem = i8_smem_bytes(KC, QT, sizeof(T) == 2);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kI8Threads, smem, st>>>(tq, tkv, scales, out, batch, l, num_heads, kv_len, sm_scale, dynamic);
  return cudaGetLastError();
}

// One block an SM (or one a pair); the key chunks pick the instantiation.
template <typename T>
cudaError_t launch_mha_int8_any(const void* qkv, const void* scales, void* out, int batch, int l,
                                int num_heads, int kv_len, float sm_scale, int dynamic,
                                cudaStream_t st) {
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  CUtensorMap tq, tkv;
  const int three_d = 3 * num_heads * kDh8;
  cudaError_t e = encode_qkv8_map(&tq, qkv, batch * l, three_d, kI8QTile);
  if (e == cudaSuccess) e = encode_qkv8_map(&tkv, qkv, batch * l, three_d, kI8Chunk);
  if (e != cudaSuccess) return e;
  const long long items = (long long)batch * num_heads;
  const int blocks = (int)(items < sms ? items : sms);
  const float* sc = static_cast<const float*>(scales);
  T* o = static_cast<T*>(out);
#define EBC_MHA8(KC_) \
  launch_mha_int8<T, KC_>(tq, tkv, sc, o, batch, l, num_heads, kv_len, sm_scale, dynamic, blocks, st)
  switch ((l + kI8Chunk - 1) / kI8Chunk) {
    case 1: return EBC_MHA8(1);
    case 2: return EBC_MHA8(2);
    case 3: return EBC_MHA8(3);
    case 4: return EBC_MHA8(4);
    default: return cudaErrorInvalidValue;
  }
#undef EBC_MHA8
}

// ---- the dynamic scale pass ---------------------------------------------------
// One launch that reads qkv once. A block owns one (window, q|k|v, head)
// slab, L rows x 64 values: it loads it once into registers (16 values a
// unit, 4 units a row, all loads in flight), reduces it to its max-abs,
// and writes that to every block of its cluster through distributed
// shared memory. A cluster is min(block_b, 4) windows of a tile x the two
// heads of a head pair, so after one cluster barrier each block holds the
// maxima its scale needs: q and v over the tile's windows of its head, k
// over the pair's too. s = max(amax, 1e-8) / 127 (IEEE division), then
// qkv_q = clip(round(v / s)) from the registers (quant_div: the same
// integers as the IEEE division, from a multiply by 1 / s but near a
// rounding half-way point), 16 int8 a 16-byte store.
// With block_b > 4 a block takes every 4th window of its tile: it keeps the
// last in registers and reads the others again (from L2) to quantize them.
// Slabs of 29 KB (bf16) or 59 KB (fp32) at L = 229: a block's registers
// hold up to 512 rows (bf16: 256 threads, 8 units a thread; fp32: 512
// threads, 4), so no shape spills to a second read. Where the time goes
// (timing-only copies, PERF.md): the wait at the cluster barrier and the
// read.
constexpr int kSMaxWindows = 4;  // windows of a cluster (x 2 heads: at most 8 blocks)

// clip(round-half-even(v / s)) with v / s the IEEE quotient, as the plain
// version rounds it, from r = 1 / s rounded (|v| <= 127 s): q = v r lies
// within 2^-23 |v / s| < 2^-16 of v / s, and the IEEE quotient within half
// an ulp (< 2^-17), so where q's fraction is more than 2^-10 from a half
// both round to the same integer; nearer a half the division decides.
__device__ __forceinline__ int quant_div(float v, float s, float r) {
  const float q = __fmul_rn(v, r);
  if (fabsf(fabsf(q - truncf(q)) - 0.5f) < 0x1p-10f) return clip8(__fdiv_rn(v, s));
  return clip8(q);
}

template <typename T>
struct QUnit;  // 16 consecutive values of a row as loaded
template <>
struct QUnit<bf16> {
  static constexpr int kThreads = 256;
  uint4 v[2];
  __device__ __forceinline__ void load(const bf16* p) {
    v[0] = reinterpret_cast<const uint4*>(p)[0];
    v[1] = reinterpret_cast<const uint4*>(p)[1];
  }
  __device__ __forceinline__ float get(int e) const {
    const uint32_t w = reinterpret_cast<const uint32_t*>(v)[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};
template <>
struct QUnit<float> {
  static constexpr int kThreads = 512;
  float4 v[4];
  __device__ __forceinline__ void load(const float* p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = reinterpret_cast<const float4*>(p)[i];
  }
  __device__ __forceinline__ float get(int e) const { return reinterpret_cast<const float*>(v)[e]; }
};

// Block i of the grid: cluster i / cs (cs = 2 cw blocks: its tile, part
// and head pair), rank i % cs (window offset rank / 2, head rank % 2 of
// the pair). KU units of 16 values a thread (4 L <= KU x threads).
template <typename T, int KU>
__global__ void __launch_bounds__(QUnit<T>::kThreads)
qkv_scale_quant_kernel(const T* __restrict__ qkv, int8_t* __restrict__ qkv_q, float* __restrict__ scales,
                 int batch, int l, int num_heads, int block_b, int cw) {
  constexpr int kThreads = QUnit<T>::kThreads;
  __shared__ float part[kThreads / 32];
  __shared__ float red[2 * kSMaxWindows];  // the maxima of the cluster's blocks, by rank
  cluster_arrive_relaxed();                // this block runs (waited on before writing to the others)
  const int cs = 2 * cw, rank = blockIdx.x % cs, pairs = num_heads / 2;
  int c = blockIdx.x / cs;
  const int hp = c % pairs;
  c /= pairs;
  const int p = c % 3, tile = c / 3;
  const int hi = rank & 1, h = 2 * hp + hi, wo = rank >> 1;
  const int d = num_heads * kDh8, three_d = 3 * d, col = p * d + h * kDh8;
  const int tid = threadIdx.x, units = 4 * l;
  // this block's windows: wo, wo + cw, ... of the tile, those that exist
  const int b0 = tile * block_b + wo, tile_end = min(tile * block_b + block_b, batch);
  const int nw = b0 < tile_end ? (tile_end - b0 + cw - 1) / cw : 0;

  QUnit<T> u[KU];
  auto load = [&](int i) {  // window b0 + cw i into the registers
    const T* base = qkv + (size_t)(b0 + cw * i) * l * three_d + col;
#pragma unroll
    for (int j = 0; j < KU; ++j) {
      const int un = tid + j * kThreads;
      if (un < units) u[j].load(base + (size_t)(un >> 2) * three_d + (un & 3) * 16);
    }
  };
  float mx = 0.f;
  for (int i = 0; i < nw; ++i) {
    load(i);
#pragma unroll
    for (int j = 0; j < KU; ++j)
      if (tid + j * kThreads < units)
#pragma unroll
        for (int e = 0; e < 16; ++e) mx = fmaxf(mx, fabsf(u[j].get(e)));
  }
  mx = warp_max(mx);
  if ((tid & 31) == 0) part[tid >> 5] = mx;
  __syncthreads();
  cluster_wait();
  if (tid < 32) {
    mx = tid < kThreads / 32 ? part[tid] : 0.f;
    mx = warp_max(mx);
    if (tid < cs) st_cluster(&red[rank], mx, tid);
  }
  cluster_arrive();
  cluster_wait();  // every block's maximum is in red
  // q and v: the tile's windows of this head; k: of the head pair too
  mx = 0.f;
  for (int r = 0; r < cs; ++r)
    if (p == 1 || (r & 1) == hi) mx = fmaxf(mx, red[r]);
  const float s = __fdiv_rn(fmaxf(mx, 1e-8f), 127.f), r = __frcp_rn(s);
  for (int i = nw - 1; i >= 0; --i) {
    if (i < nw - 1) load(i);
    const int b = b0 + cw * i;
    if (tid == 0) scales[((size_t)b * num_heads + h) * 3 + p] = s;
    int8_t* dst = qkv_q + (size_t)b * l * three_d + col;
#pragma unroll
    for (int j = 0; j < KU; ++j) {
      const int un = tid + j * kThreads;
      if (un < units) {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int e = 0; e < 16; ++e) w[e >> 2] |= (uint32_t)(quant_div(u[j].get(e), s, r) & 0xff) << (8 * (e & 3));
        *reinterpret_cast<uint4*>(dst + (size_t)(un >> 2) * three_d + (un & 3) * 16) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

template <typename T, int KU>
cudaError_t launch_quant_ku(const void* qkv, void* qkv_q, void* scales, int batch, int l, int num_heads,
                            int block_b, cudaStream_t st) {
  const int cw = block_b < kSMaxWindows ? block_b : kSMaxWindows;
  const long long blocks = (long long)((batch + block_b - 1) / block_b) * 3 * (num_heads / 2) * 2 * cw;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  return launch_clustered(qkv_scale_quant_kernel<T, KU>, (int)blocks, QUnit<T>::kThreads, 0, 2 * cw, st,
                          static_cast<const T*>(qkv), static_cast<int8_t*>(qkv_q), static_cast<float*>(scales),
                          batch, l, num_heads, block_b, cw);
}

template <typename T>
cudaError_t launch_quant_dynamic(const void* qkv, void* qkv_q, void* scales, int batch, int l, int num_heads,
                                 int block_b, cudaStream_t st) {
  const int ku = (4 * l + QUnit<T>::kThreads - 1) / QUnit<T>::kThreads;  // 1 .. 4 kI8MaxKeys / threads
  if (ku <= 1) return launch_quant_ku<T, 1>(qkv, qkv_q, scales, batch, l, num_heads, block_b, st);
  if (ku <= 2) return launch_quant_ku<T, 2>(qkv, qkv_q, scales, batch, l, num_heads, block_b, st);
  if (ku <= 4) return launch_quant_ku<T, 4>(qkv, qkv_q, scales, batch, l, num_heads, block_b, st);
  if constexpr (4 * kI8MaxKeys > 4 * QUnit<T>::kThreads)
    if (ku <= 8) return launch_quant_ku<T, 8>(qkv, qkv_q, scales, batch, l, num_heads, block_b, st);
  return cudaErrorInvalidValue;
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

// The dynamic scale pass: qkv (B, L, 3D) bf16, or fp32 when is_f32; qkv_q
// (B, L, 3D) int8 and scales (B, H, 3) fp32 out (s_q, s_k, s_v of each
// window and head, tiles of block_b windows).
extern "C" int ebc_qkv_quant_dynamic(const void* qkv, void* qkv_q, void* scales, int batch, int l, int d,
                                     int num_heads, int block_b, int is_f32, void* stream) {
  using namespace ebc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!attention_shape_ok(l, d, num_heads, l) || num_heads % 2 || batch < 1 || block_b < 1)
    return (int)cudaErrorInvalidValue;
  return (int)(is_f32 ? launch_quant_dynamic<float>(qkv, qkv_q, scales, batch, l, num_heads, block_b, st)
                      : launch_quant_dynamic<bf16>(qkv, qkv_q, scales, batch, l, num_heads, block_b, st));
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
