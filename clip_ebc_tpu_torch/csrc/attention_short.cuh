// The whole-row ("short") softmax attention bodies shared by
// csrc/flash_attention.cu (the short flash route) and
// csrc/fused_attention.cu (the masked attention of a packed qkv): one
// bf16 body on the tensor cores and one fp32 body on the FMA units, each
// templated on where P is normalized.
//  * kNormAfter = false (the short flash route; JAX _short_kernel):
//    p = exp(s - max) / sum, normalized before it is rounded and
//    multiplied by V (the sum's reciprocal times each p).
//  * kNormAfter = true (the masked attention; JAX _pair_attention_body):
//    p = exp(s - max) unnormalized, rounded for P V, and O divided by the
//    fp32 row sum: bf16 multiplies O by the sum's reciprocal (one IEEE
//    division a row, not 32 a thread; the product can differ from O / sum
//    in the last fp32 place before O is rounded to bf16), fp32 divides each
//    O by the sum, as the plain version does.
// Both: fp32 scores x scale, keys >= lk (and, when causal, keys above the
// row) at kNegInf, the row max and sum exact over the row, P V accumulated
// in fp32. q, k, v and out are addressed by (batch, head, row) strides in
// elements with contiguous 64-wide rows (FlashArgs), so the head views of
// a joint qkv (B, L, 3D) and a (B, L, D) output need no copy. The masked
// attention passes lk = kv_len: keys past it land as zeros and are
// masked, which gives p = 0 there exactly as a key in [kv_len, L) would.
//
// Bound. At the windows' shape (B = 140, L = 229, 12 heads) a call does
// 22.6 GFLOP of QK^T and PV against 197 MB of q, k, v and out in bf16 (0.059
// ms at 3.35 TB/s over 0.023 ms on the tensor cores): bytes bound the bf16
// body, so it reads each (window, head)'s Q, K and V once and keeps its
// loads in flight under the products. In fp32 the same work is 0.337 ms on
// the FMA units (67 TFLOP/s) against 0.118 ms of memory: operations bound
// the fp32 body, which keeps the FMA units fed from registers.
//
// Design, bf16 (wgmma, TMA, sm_90a). A persistent block of three
// warpgroups on each SM walks the items (batch, head, part): a pair's query
// tiles in `split` parts (1, or 2 at small batch, where one part a pair
// would leave most SMs with one item and a third of them with two). An
// item's Q tiles, K and V land in shared memory by TMA (128B-swizzled rows
// of 64 values; rows past the sequence land as zeros), in one of two
// stages, completing on the stage's mbarrier, so the next item's loads run
// under this item's products. The block's query tiles, item by item, go to
// the warpgroups in turn, and no block-wide barrier separates the items: a
// warpgroup with no tile left in an item goes on to the next item's while
// the others finish, and the last of the three done with a stage issues
// the loads that refill it. Three warpgroups (168 registers a thread) and
// no per-item barrier, against the first design's two warpgroups, a
// cp.async stage waited on by all and two block-wide barriers an item,
// took 0.087 against 0.111 ms at the windows' shape on an H100 SXM at 700
// W: the body is bound by the latency of its chain of dependent steps
// (each unit near a quarter busy), so more warps in flight pay. S = Q K^T
// is wgmma m64n128k16 per 128-key chunk, Q and K both
// K-major from shared memory, S in registers (64 fp32 a thread a chunk).
// Up to 256 keys the whole score row stays in registers and the softmax
// is one exact pass: mask, the row max of the raw scores (scale > 0) over
// the lane quad, p = exp(s scale - max scale) as 2^(s c2 - max c2), c2 =
// scale log2(e), one FMA and one ex2.approx an element, the row sum over
// the fp32 p. P, rounded to bf16, goes from the accumulators to the
// register A operand of wgmma m64n64k16 in their own layout, and V is the
// B operand as its rows stand (MN-major: the descriptor's transpose bit),
// so nothing is transposed. O is rounded to bf16, staged in the tile's Q
// rows and written in 16-byte stores. Past 256 keys (up to 512) the row no
// longer fits and an item takes all of shared memory: the first sweep over
// the chunks takes the row max and sum online, the second recomputes S and
// multiplies P by V. Tried and dropped on the two-warpgroup design: the two
// warpgroups taking turns to issue their products (named barriers), no
// faster; skipping the mask and the exponentials of whole 8-key blocks
// past the valid keys (warp-uniform branches), slower, as was the tiled
// kernel with the same change; skipping the softmax of warps whose rows
// are all padding, no faster.
//
// Design, fp32 (register-blocked SIMT: the tensor cores take no fp32
// operands short of TF32, which would round where the plain version does
// not). One block of 256 threads (16 x 16) per (64-query tile, head,
// batch). The tile's Q rows and all of K land by 16-byte cp.async (rows
// padded to 68 floats, so a half warp's float4 reads hit distinct banks).
// Thread (ty, tx) scores rows 4 ty .. + 3 against keys tx + 16 j, each
// float4 of K feeding 16 FMAs, so the whole score row (the keys padded to
// a multiple of 16) stays in registers and the softmax is exact over it,
// its max and sum over the half warp that shares a row. P^T takes K's
// place in shared memory; O = P V is 4 x 4 outputs a thread over the keys
// that can be valid. V comes in 64-key chunks, two in flight, one landing
// under the scores and the next in Q's place, so a block takes 103 KB of
// shared memory at 256 keys and two blocks share an SM (one's loads and
// barriers run under the other's FMAs); past 256 keys (up to 512: 128
// score registers a thread, 172 KB) one block an SM.

#pragma once

#include "common.cuh"

namespace ebc {
namespace {

constexpr int kDh = 64;  // head dim
constexpr int kBq = 64;  // query rows of a tile
constexpr float kLog2e = 1.4426950408889634f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, h, lq, lk;
  long long qs[3], ks[3], vs[3], os[3];  // batch, head, row strides in elements
  float scale;
  int causal;
};

// ---- TMA and mbarriers ------------------------------------------------------

// Where the rows, heads and batch of a (64, rows, heads, batch) tensor map
// lie among its dims 1..3 (ordered by stride), for q, k and v.
struct TmaDims {
  int q[3], k[3], v[3];
};

// TMA: the box of ``map`` at (row, h, b) into dst (1024-byte aligned),
// completing on ``bar``; rows outside the tensor land as zeros.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, const int (&pos)[3],
                                         int row, int h, int b, uint64_t* bar) {
  const int c1 = pos[0] == 1 ? row : pos[1] == 1 ? h : b;
  const int c2 = pos[0] == 2 ? row : pos[1] == 2 ? h : b;
  const int c3 = pos[0] == 3 ? row : pos[1] == 3 ? h : b;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(c1), "r"(c2), "r"(c3),
         "r"(smem_addr(bar))
      : "memory");
}

// A bf16 tensor map of (64, rows, heads, batch) at ptr with (batch, head,
// row) strides st in elements, dims 1..3 ordered by stride; boxes of 64 x
// box_rows, 128B-swizzled (the layout sw128_desc reads). pos gets where
// rows, heads and batch went.
cudaError_t encode_rows_map(CUtensorMap* map, int (&pos)[3], const void* ptr, int rows, int h, int b,
                            const long long (&st)[3], int box_rows) {
  const long long stride[3] = {st[2], st[1], st[0]};  // rows, heads, batch
  const cuuint64_t extent[3] = {(cuuint64_t)rows, (cuuint64_t)h, (cuuint64_t)b};
  int order[3] = {0, 1, 2};
  for (int x = 1; x < 3; ++x)
    for (int y = x; y > 0 && stride[order[y]] < stride[order[y - 1]]; --y) {
      const int tmp = order[y];
      order[y] = order[y - 1];
      order[y - 1] = tmp;
    }
  cuuint64_t dims[4] = {(cuuint64_t)kDh, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {(cuuint32_t)kDh, 1, 1, 1};
  for (int x = 0; x < 3; ++x) {
    const int which = order[x];
    dims[x + 1] = extent[which];
    strides[x] = (cuuint64_t)stride[which] * sizeof(bf16);
    box[x + 1] = which == 0 ? (cuuint32_t)box_rows : 1u;
    pos[which] = x + 1;
  }
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---- bf16 (wgmma) -----------------------------------------------------------

constexpr int kSWarpgroups = 3;               // consumers, a 64-row query tile at a time each
constexpr int kSThreads = kSWarpgroups * 128;
constexpr int kSChunk = 128;    // keys of one S = Q K^T wgmma (its N)
constexpr int kSRegChunks = 2;  // up to 256 keys the whole score row stays in registers

// One stage: QT Q tiles of 64 rows, then K and V of KC chunks, rows of 128 B.
__host__ __device__ constexpr size_t short_stage_bytes(int kc, int qt) { return (size_t)(qt * kBq + 2 * kc * kSChunk) * 128; }
__host__ __device__ constexpr int short_stages(int kc, int qt) { return kc <= kSRegChunks && qt <= 4 ? 2 : 1; }
// the stages, then a full barrier and a done count each; 1024-byte alignment
inline size_t short_smem_bytes(int kc, int qt) { return short_stages(kc, qt) * short_stage_bytes(kc, qt) + 32 + 1024; }

// d (64 x 64 fp32) (+)= A (64 x 16 bf16 in registers: warp w's 16 rows in the
// mma_bf16 A layout) . B (16 x 64 bf16, MN-major in shared memory: 16 rows of
// 64 values, 128B-swizzled, the transpose bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
      "1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// Issues S (64 x 128) = Q tile . K chunk^T (4 wgmma along the head dim; no
// commit). Thread i of the warpgroup holds rows 16 (i / 32) + g and + 8,
// keys 8 j + 2t, + 1 of the chunk in s[4 j .. 4 j + 3], as in mma_bf16.
__device__ __forceinline__ void short_scores(float (&s)[64], const unsigned char* qt,
                                             const unsigned char* kc) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    wgmma_m64n128k16(s, sw128_desc(qt + kk * 32), sw128_desc(kc + kk * 32), kk > 0);
}

// 2^x (ex2.approx.ftz: a p below 2^-126 of its row max flushes to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Masks the raw scores of a chunk in place (keys >= lim0 of row r0, >= lim1
// of row r0 + 8 at kNegInf; nothing to do when the chunk lies below both)
// and takes its max of the two rows (this thread's share; the caller
// reduces over the lane quad). The scale is applied after the max: scale >
// 0, so max(s scale) = max(s) scale.
__device__ __forceinline__ void short_mask_max(float (&s)[64], int col0, int lim0, int lim1, int t,
                                               float& mx0, float& mx1) {
  if (col0 + kSChunk > min(lim0, lim1)) {
#pragma unroll
    for (int j = 0; j < kSChunk / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + j * 8 + 2 * t + e;
        if (col >= lim0) s[4 * j + e] = kNegInf;
        if (col >= lim1) s[4 * j + 2 + e] = kNegInf;
      }
  }
#pragma unroll
  for (int j = 0; j < kSChunk / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
}

// p = exp(s scale - max scale) = 2^(s c2 - max c2) in place, c2 = scale
// log2(e); adds each row's p to l0, l1. A masked s (kNegInf) gives 0.
__device__ __forceinline__ void short_exp(float (&s)[64], float c2, float mc0, float mc1, float& l0,
                                          float& l1) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = fast_exp2(fmaf(s[i], c2, (i & 2) ? mc1 : mc0));
    ((i & 2) ? l1 : l0) += s[i];
  }
}

// P of a chunk rounded to bf16 in the register A operand layout of its 8
// 16-key steps: the accumulators as they lie.
__device__ __forceinline__ void short_pack(uint32_t (&pa)[kSChunk / 16][4], const float (&p)[64]) {
#pragma unroll
  for (int k = 0; k < kSChunk / 16; ++k) {
    pa[k][0] = pack_bf16(p[8 * k], p[8 * k + 1]);
    pa[k][1] = pack_bf16(p[8 * k + 2], p[8 * k + 3]);
    pa[k][2] = pack_bf16(p[8 * k + 4], p[8 * k + 5]);
    pa[k][3] = pack_bf16(p[8 * k + 6], p[8 * k + 7]);
  }
}

// Issues O += P chunk . V chunk (8 wgmma of 16 keys; no commit). The
// caller fences after packing P: wgmma reads its A registers asynchronously.
__device__ __forceinline__ void short_pv(float (&o)[32], const uint32_t (&pa)[kSChunk / 16][4],
                                         const unsigned char* vc, bool first) {
#pragma unroll
  for (int k = 0; k < kSChunk / 16; ++k)
    wgmma_m64n64k16_rs(o, pa[k], sw128_desc(vc + k * 16 * 128), !first || k > 0);
}

// O (64 x 64) of one query tile: the softmax of its rows against the KC key
// chunks at ks, times V at vs. r0 = the thread's first row.
template <int KC, bool kNormAfter>
__device__ __forceinline__ void short_tile(float (&o)[32], const FlashArgs& a, const unsigned char* qt,
                                           const unsigned char* ks, const unsigned char* vs, int r0,
                                           int t) {
  const float c2 = a.scale * kLog2e;
  // valid keys of rows r0 and r0 + 8: below lk, and up to the row when causal
  const int lim0 = a.causal ? min(a.lk, r0 + 1) : a.lk;
  const int lim1 = a.causal ? min(a.lk, r0 + 9) : a.lk;
  float l0 = 0.f, l1 = 0.f;
  if constexpr (KC <= kSRegChunks) {
    // one pass: the whole score row in registers
    float s[KC][64];
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int i = 0; i < 64; ++i) s[c][i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KC; ++c) short_scores(s[c], qt, ks + c * kSChunk * 128);
    wgmma_commit();
    wgmma_wait<0>();
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int c = 0; c < KC; ++c) short_mask_max(s[c], c * kSChunk, lim0, lim1, t, mx0, mx1);
    quad_max(mx0, mx1);
#pragma unroll
    for (int c = 0; c < KC; ++c) short_exp(s[c], c2, -mx0 * c2, -mx1 * c2, l0, l1);
    quad_sum(l0, l1);
    uint32_t pa[KC][kSChunk / 16][4];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if constexpr (!kNormAfter) {
        const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
        for (int i = 0; i < 64; ++i) s[c][i] *= (i & 2) ? inv1 : inv0;
      }
      short_pack(pa[c], s[c]);
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KC; ++c) short_pv(o, pa[c], vs + c * kSChunk * 128, c == 0);
    wgmma_commit();
    wgmma_wait<0>();
  } else {
    // two sweeps: the row max and sum online, then P V chunk by chunk
    float s[64];
    float m0 = kNegInf, m1 = kNegInf;
#pragma unroll 1
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.f;
      wgmma_fence();
      short_scores(s, qt, ks + c * kSChunk * 128);
      wgmma_commit();
      wgmma_wait<0>();
      float mx0 = m0, mx1 = m1;
      short_mask_max(s, c * kSChunk, lim0, lim1, t, mx0, mx1);
      quad_max(mx0, mx1);
      float p0 = 0.f, p1 = 0.f;
      short_exp(s, c2, -mx0 * c2, -mx1 * c2, p0, p1);
      l0 = fast_exp2((m0 - mx0) * c2) * l0 + p0;
      l1 = fast_exp2((m1 - mx1) * c2) * l1 + p1;
      m0 = mx0;
      m1 = mx1;
    }
    quad_sum(l0, l1);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll 1
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.f;
      wgmma_fence();
      short_scores(s, qt, ks + c * kSChunk * 128);
      wgmma_commit();
      wgmma_wait<0>();
      float mx0 = kNegInf, mx1 = kNegInf;
      short_mask_max(s, c * kSChunk, lim0, lim1, t, mx0, mx1);
      float d0 = 0.f, d1 = 0.f;
      short_exp(s, c2, -m0 * c2, -m1 * c2, d0, d1);
      if constexpr (!kNormAfter) {
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] *= (i & 2) ? inv1 : inv0;
      }
      uint32_t pa[kSChunk / 16][4];
      short_pack(pa, s);
      wgmma_fence();
      short_pv(o, pa, vs + c * kSChunk * 128, c == 0);
      wgmma_commit();
      wgmma_wait<0>();
    }
  }
  if constexpr (kNormAfter) {
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
    for (int k = 0; k < 32; ++k) o[k] *= (k & 2) ? inv1 : inv0;
  }
}

// Persistent: block i takes the items i, i + gridDim.x, ... of (batch,
// head, part), parts fastest; part p of a pair holds its query tile pairs
// (2 j, 2 j + 1) for j = p, p + split, ... (split = 1 or 2). The block's
// query tiles, item by item, go to its three warpgroups in turn, so a
// warpgroup with no tile left in an item goes on to the next item's while
// the others finish. KC = ceil(lk / 128) key chunks, QT = Q tiles a stage
// holds (4 or 8). An item's Q tiles, K and V land in its stage by TMA (one
// thread issues them, completing on the stage's full barrier); the last
// warpgroup done with a stage refills it with the item kStages on.
template <int KC, int QT, bool kNormAfter>
__global__ void __launch_bounds__(kSThreads, 1)
short_bf16_kernel(const FlashArgs a, int split, const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const TmaDims dims) {
  constexpr int kStages = short_stages(KC, QT);
  constexpr size_t kStage = short_stage_bytes(KC, QT);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + kStages * kStage);  // [kStages]
  int* done = reinterpret_cast<int*>(full + kStages);                    // [kStages]

  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  // warp-uniform as the compiler sees it (a shuffle of lane 0's value), so
  // the wgmma do not lie on a divergent path
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int g = lane >> 2, t = lane & 3;
  const int sh = split - 1;  // item w: pair w >> sh, part w & sh
  const int n_items = a.b * a.h * split, n_qt = (a.lq + kBq - 1) / kBq;
  const int first = blockIdx.x, step = gridDim.x;

  // the Q tiles of item w's part, K and V of its pair into stage st by TMA,
  // completing on full[st]; rows past lq and keys past lk land as zeros
  // (0 * V stays finite). One thread.
  auto load = [&](int w, int st) {
    const int pair = w >> sh, part = w & sh;
    const int b = pair / a.h, h = pair % a.h;
    unsigned char* qd = sm + st * kStage;
    unsigned char* kd = qd + QT * kBq * 128;
    unsigned char* vd = kd + KC * kSChunk * 128;
    int n = 0;
    for (int qt = 2 * part; qt < n_qt; qt += 2 * split) n += min(2, n_qt - qt);
    mbar_expect_tx(&full[st], (uint32_t)(n * kBq * 128 + 2 * KC * kSChunk * 128));
    for (int qt = 2 * part; qt < n_qt; qt += 2 * split)
      for (int u = 0; u < 2 && qt + u < n_qt; ++u)
        tma_rows(qd + (qt + u) * kBq * 128, &tq, dims.q, (qt + u) * kBq, h, b, &full[st]);
    for (int c = 0; c < KC; ++c) {
      tma_rows(kd + c * kSChunk * 128, &tk, dims.k, c * kSChunk, h, b, &full[st]);
      tma_rows(vd + c * kSChunk * 128, &tv, dims.v, c * kSChunk, h, b, &full[st]);
    }
  };

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      done[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < kStages; ++st)
      if (first + st * step < n_items) load(first + st * step, st);
  }
  __syncthreads();

  int gt = 0;  // the block's query tiles in order: tile gt goes to warpgroup gt % 3
  int i = 0;
  for (int w = first; w < n_items; w += step, ++i) {
    const int st = i % kStages;
    mbar_wait(&full[st], (i / kStages) & 1);  // item w landed

    const int pair = w >> sh, part = w & sh;
    const int b = pair / a.h, h = pair % a.h;
    bf16* ob = static_cast<bf16*>(a.o) + b * a.os[0] + h * a.os[1];
    unsigned char* qs = sm + st * kStage;
    const unsigned char* ks = qs + QT * kBq * 128;
    const unsigned char* vs = ks + KC * kSChunk * 128;
    for (int q0 = 2 * part; q0 < n_qt; q0 += 2 * split) {
      for (int qt = q0; qt < q0 + 2 && qt < n_qt; ++qt) {
        if (gt++ % kSWarpgroups != wg) continue;
        unsigned char* q_tile = qs + qt * kBq * 128;
        const int rl = warp * 16 + g, r0 = qt * kBq + rl;
        float o[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) o[k] = 0.f;
        short_tile<KC, kNormAfter>(o, a, q_tile, ks, vs, r0, t);
        // O rounded to bf16 and staged swizzled in the tile's Q rows (read by
        // its finished products only), then written out in 16-byte stores
#pragma unroll
        for (int j = 0; j < kDh / 8; ++j) {
          *reinterpret_cast<uint32_t*>(q_tile + sw128_offset(rl, j) + 4 * t) = pack_bf16(o[4 * j], o[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(q_tile + sw128_offset(rl + 8, j) + 4 * t) =
              pack_bf16(o[4 * j + 2], o[4 * j + 3]);
        }
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");  // this warpgroup only
        for (int k = tid & 127; k < kBq * 8; k += 128) {
          const int r = k >> 3, c = k & 7, row = qt * kBq + r;
          if (row < a.lq)
            *reinterpret_cast<uint4*>(ob + row * a.os[2] + c * 8) =
                *reinterpret_cast<const uint4*>(q_tile + sw128_offset(r, c));
        }
      }
    }
    // this warpgroup is done with stage st: its reads before the next TMA
    // write; the last of the three refills the stage
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if ((tid & 127) == 0 && atomicAdd(&done[st], 1) == kSWarpgroups - 1) {
      done[st] = 0;
      if (w + kStages * step < n_items) load(w + kStages * step, st);
    }
  }
}

template <int KC, int QT, bool kNormAfter>
cudaError_t launch_short_bf16(const FlashArgs& a, int blocks, int split, const CUtensorMap& tq,
                              const CUtensorMap& tk, const CUtensorMap& tv, const TmaDims& dims,
                              cudaStream_t st) {
  const size_t smem = short_smem_bytes(KC, QT);
  cudaError_t e = cudaFuncSetAttribute(short_bf16_kernel<KC, QT, kNormAfter>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  short_bf16_kernel<KC, QT, kNormAfter><<<blocks, kSThreads, smem, st>>>(a, split, tq, tk, tv, dims);
  return cudaGetLastError();
}

// One block an SM (or one an item); the key chunks (up to kMaxKC) and the
// Q tiles pick the instantiation. A pair's query tiles go to two items
// when one item a pair would leave the card under 1.5 items an SM (a
// calibration batch, 16 windows x 12 heads on 132 SMs) and the pair has
// more than two tiles: each part restages K and V (from L2), but the SMs
// finish together. The tensor maps cover the (batch, head, row)-strided
// views: Q in 64-row boxes, K and V in 128-row boxes.
template <bool kNormAfter, int kMaxKC>
cudaError_t launch_short_bf16_any(const FlashArgs& a, cudaStream_t st) {
  if (a.b < 1 || a.h < 1 || a.lq < 1 || a.lk < 1 || a.lq > 512 || a.lk > kMaxKC * kSChunk)
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  CUtensorMap tq, tk, tv;
  TmaDims dims;
  cudaError_t e = encode_rows_map(&tq, dims.q, a.q, a.lq, a.h, a.b, a.qs, kBq);
  if (e == cudaSuccess) e = encode_rows_map(&tk, dims.k, a.k, a.lk, a.h, a.b, a.ks, kSChunk);
  if (e == cudaSuccess) e = encode_rows_map(&tv, dims.v, a.v, a.lk, a.h, a.b, a.vs, kSChunk);
  if (e != cudaSuccess) return e;
  const long long pairs = (long long)a.b * a.h;
  const int split = (a.lq > 2 * kBq && 2 * pairs < 3LL * sms) ? 2 : 1;
  const long long items = pairs * split;
  const int blocks = (int)(items < sms ? items : sms);
  const bool long_q = a.lq > 4 * kBq;
#define EBC_SHORT_BF16(KC_)                                                                    \
  (long_q ? launch_short_bf16<KC_, 8, kNormAfter>(a, blocks, split, tq, tk, tv, dims, st)      \
          : launch_short_bf16<KC_, 4, kNormAfter>(a, blocks, split, tq, tk, tv, dims, st))
  switch ((a.lk + kSChunk - 1) / kSChunk) {
    case 1: return EBC_SHORT_BF16(1);
    case 2: return EBC_SHORT_BF16(2);
    case 3: return EBC_SHORT_BF16(3);
    default:
      if constexpr (kMaxKC >= 4)
        return EBC_SHORT_BF16(4);
      else
        return cudaErrorInvalidValue;
  }
#undef EBC_SHORT_BF16
}

// ---- fp32 (register-blocked SIMT) ------------------------------------------

constexpr int kFAttnThreads = 256;    // 16 x 16
constexpr int kFAttnTile = 64;        // query rows of a block
constexpr int kFAttnPitch = kDh + 4;  // 68: Q, K and P^T rows; a half warp's float4s hit distinct banks
constexpr int kFVChunk = 64;          // keys of a V chunk in P.V

// The Q tile (a V chunk after the scores), K (P^T after the scores) for LP
// padded keys, and a second V chunk.
inline size_t short_f32_smem_bytes(int lp) {
  return ((size_t)(kFAttnTile + lp) * kFAttnPitch + (size_t)kFVChunk * kDh) * sizeof(float);
}

// rows [0, n) of a (rows, 64) fp32 slice of row stride ``pitch`` (elements)
// into shared memory at row pitch ``spitch``, rows [n, total) zero
// (cp.async, uncommitted)
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, int n, int total,
                                               long long pitch, int spitch) {
  for (int i = threadIdx.x; i < total * (kDh / 4); i += kFAttnThreads) {
    const int r = i >> 4, c = (i & 15) * 4;
    cp_async16(dst + r * spitch + c, src + (r < n ? r : 0) * pitch + c, r < n);
  }
}

// max (or sum) of a row over the 16 lanes that share it (a half warp)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block of 256 threads (16 x 16) per (64-query tile, head, batch); NJ =
// keys a thread scores, the key count padded to 16 NJ. Thread (ty, tx)
// scores rows 4 ty + i against keys tx + 16 j, the whole row in registers,
// then computes rows 4 ty + i x columns 4 tx + c of O. Two blocks share an
// SM up to 256 keys.
template <int NJ, bool kNormAfter>
__global__ void __launch_bounds__(kFAttnThreads, NJ <= 16 ? 2 : 1) short_f32_kernel(const FlashArgs a) {
  constexpr int LP = 16 * NJ;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                           // [kFAttnTile][kFAttnPitch]: Q, then V chunks 1, 3, ...
  float* ks = qs + kFAttnTile * kFAttnPitch; // [LP][kFAttnPitch]: K, then P^T
  float* vx = ks + LP * kFAttnPitch;         // [kFVChunk][kDh]: V chunks 0, 2, ...
  const int q0 = blockIdx.x * kFAttnTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qb = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* kb = static_cast<const float*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const float* vb = static_cast<const float*>(a.v) + b * a.vs[0] + h * a.vs[1];
  float* ob = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1];
  // keys of P.V: p is exactly 0 at the others (past lk, or past the tile's
  // last row when causal)
  const int nk = a.causal ? min(a.lk, q0 + kFAttnTile) : a.lk;
  const int n_chunks = (nk + kFVChunk - 1) / kFVChunk;
  auto stage_v = [&](int c) {  // V chunk c into its buffer; always a commit group
    if (c < n_chunks)
      stage_rows_f32(c & 1 ? qs : vx, vb + (long long)c * kFVChunk * a.vs[2], a.lk - c * kFVChunk,
                     kFVChunk, a.vs[2], kDh);
    cp_async_commit();
  };

  // Q and K land first; V chunk 0 lands while the scores are computed
  stage_rows_f32(qs, qb + (long long)q0 * a.qs[2], a.lq - q0, kFAttnTile, a.qs[2], kFAttnPitch);
  stage_rows_f32(ks, kb, a.lk, LP, a.ks[2], kFAttnPitch);
  cp_async_commit();
  stage_v(0);
  cp_async_wait<1>();
  __syncthreads();

  // S = Q K^T over the head dim in order: each float4 of K feeds 16 FMAs
  float s[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int dd = 0; dd < kDh; dd += 4) {
    float4 qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kFAttnPitch + dd);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kFAttnPitch + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
      }
    }
  }

  // x scale, invalid keys (padding included) at kNegInf; the exact row max
  // and sum over the 16 lanes of a half warp that share the row; p =
  // exp(s - max), normalized here (x the sum's reciprocal) unless
  // kNormAfter
  float sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    const int lim = a.causal ? min(a.lk, row + 1) : a.lk;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[i][j] = tx + 16 * j < lim ? s[i][j] * a.scale : kNegInf;
      mx = fmaxf(mx, s[i][j]);
    }
    mx = half_max(mx);
    float sm = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[i][j] = expf(s[i][j] - mx);
      sm += s[i][j];
    }
    sum[i] = half_sum(sm);
    if constexpr (!kNormAfter) {
      const float inv = 1.f / sum[i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] *= inv;
    }
  }
  __syncthreads();  // Q and K are read: P^T takes K's place, V chunk 1 Q's
  stage_v(1);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    *reinterpret_cast<float4*>(ks + (tx + 16 * j) * kFAttnPitch + 4 * ty) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

  // O = P V chunk by chunk (chunk c + 1 lands while c is multiplied)
  float o[4][4] = {};
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();  // chunk c has landed (c + 1 may still be in flight)
    __syncthreads();
    const float* vc = c & 1 ? qs : vx;
    const int k0 = c * kFVChunk, kn = min(kFVChunk, nk - k0);
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      const float4 p = *reinterpret_cast<const float4*>(ks + (k0 + k) * kFAttnPitch + 4 * ty);
      const float4 v = *reinterpret_cast<const float4*>(vc + k * kDh + 4 * tx);
      const float pv[4] = {p.x, p.y, p.z, p.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) o[i][cc] = fmaf(pv[i], vv[cc], o[i][cc]);
    }
    __syncthreads();  // chunk c is read: its buffer takes chunk c + 2
    stage_v(c + 2);
  }
  cp_async_wait<0>();
  // O (/ the row sum when kNormAfter: the plain version's order)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    const float d = kNormAfter ? sum[i] : 1.f;
    if (r < a.lq)
      *reinterpret_cast<float4*>(ob + r * a.os[2] + 4 * tx) =
          make_float4(o[i][0] / d, o[i][1] / d, o[i][2] / d, o[i][3] / d);
  }
}

template <int NJ, bool kNormAfter>
cudaError_t launch_short_f32(const FlashArgs& a, cudaStream_t st) {
  const size_t smem = short_f32_smem_bytes(16 * NJ);
  cudaError_t e = cudaFuncSetAttribute(short_f32_kernel<NJ, kNormAfter>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.lq + kFAttnTile - 1) / kFAttnTile, a.h, a.b);
  short_f32_kernel<NJ, kNormAfter><<<grid, kFAttnThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The smallest instantiation NJ >= nj among 1, 2, ..., 20, 24, 28, 32 (up
// to kMaxNJ): keys padded to a multiple of 16, of 64 past 320.
template <bool kNormAfter, int kMaxNJ, int NJ = 1>
cudaError_t launch_short_f32_nj(const FlashArgs& a, int nj, cudaStream_t st) {
  if constexpr (NJ > kMaxNJ) {
    return cudaErrorInvalidValue;
  } else {
    if (nj <= NJ) return launch_short_f32<NJ, kNormAfter>(a, st);
    return launch_short_f32_nj<kNormAfter, kMaxNJ, (NJ < 20 ? NJ + 1 : NJ + 4)>(a, nj, st);
  }
}

template <bool kNormAfter, int kMaxNJ>
cudaError_t launch_short_f32_any(const FlashArgs& a, cudaStream_t st) {
  if (a.b < 1 || a.h < 1 || a.lq < 1 || a.lk < 1 || a.b > 65535 || a.h > 65535)
    return cudaErrorInvalidValue;
  return launch_short_f32_nj<kNormAfter, kMaxNJ>(a, (a.lk + 15) / 16, st);
}

}  // namespace
}  // namespace ebc
