// Flash attention softmax(Q K^T * scale) V on (B, H, L, 64) q, k, v: the
// two routes of clip_ebc_tpu/ops/flash_attention.py.
//  * tiled (ports _flash_forward's pallas_call, kernel _kernel): online
//    softmax over 128-key tiles; per tile alpha = exp(m - m_next), p =
//    exp(s - m_next) rounded to v's dtype unnormalized, acc = acc * alpha +
//    p V; at the end acc * (1 / l), 1 where l == 0. Causal tiles wholly above
//    the diagonal are skipped; keys >= Lk are masked.
//  * short (ports _flash_forward_short's pallas_call, kernel _short_kernel):
//    the whole row's softmax, p = exp(s - max) / sum normalized BEFORE it is
//    rounded and multiplied by V (the sum's reciprocal times each p).
// Both: fp32 scores, x scale unless it is 1.0, masked entries at kNegInf
// (-0.7 * float max, the JAX constant), P.V accumulated in fp32.
//
// Bound. The full image's trunk (L = 24,609, 12 heads, B = 1) does 4 L^2 64
// = 1.86 TFLOP of QK^T and PV a call against 4 x 24,609 x 768 x 2 B = 151
// MB of q, k, v and out: 1.88 ms of bf16 tensor-core work (989 TFLOP/s)
// against 0.045 ms of memory (3.35 TB/s), so operations bound the tiled
// route and the design keeps the tensor cores fed. The short route at the
// windows' shape (B = 140, L = 229) does 22.6 GFLOP against 197 MB: bytes
// bound it (0.059 ms).
//
// Design, tiled bf16 (wgmma, TMA, sm_90a; redesigned after the first port,
// mma.sync with an ldmatrix per product in blocks of 4 warps over 64
// queries, whose K and V tiles were restaged from L2 by each of the 385
// query blocks of a head through a 2-stage cp.async ring that waited on its
// loads, with the softmax in series with the products: 192 TFLOP/s, 2.1x
// the cuDNN forward). A persistent block on each SM walks the (128-row
// query tile, head, batch) items, query tiles fastest, so a head's K and V
// (12.6 MB) stay in L2 while the card works on it; with causal the longest
// tiles go first. One producer warp keeps the loads in flight by TMA with
// mbarriers: the item's Q tile (two buffers, so the next item's lands
// early) and a 3-stage ring of 128-key K and V tiles (the JAX block_k, so
// the online softmax rescales at the same keys as the TPU kernel; 16 KB
// each, 128B-swizzled by the copy; rows past the sequence land as zeros, so
// 0 x V stays finite). The tensor maps are encoded per call on the host
// over the (batch, head, row)-strided views by cuTensorMapEncodeTiled,
// fetched at run time by cudaGetDriverEntryPoint (nothing links -lcuda). Two consumer
// warpgroups own 64 query rows each (so a K/V tile feeds 128 queries, half
// the L2 traffic of the first port's 64): S_j = Q K_j^T is wgmma m64n128k16
// from shared memory, 64 fp32 a thread; it is issued, then P_{j-1} V_{j-1},
// and the softmax of S_j (mask, the running max of the raw scores over the
// lane quad, alpha = 2^((m - m_next) c2), p = 2^(s c2 - m_next c2), one FMA
// and one ex2.approx an element, c2 = scale log2(e), l = alpha l + sum p in
// fp32) runs while that product is in flight. Then acc *= alpha and P,
// rounded to bf16 unnormalized, is packed from the accumulators as the
// register A operand of wgmma m64n64k16 against V, the MN-major B operand as
// its rows stand: the rounding points of _kernel. A stage goes back to the
// producer once both warpgroups' products on it are done. At the end acc *
// (1 / l), rounded to bf16, staged in the warpgroup's Q rows and written in
// 16-byte stores. Tried and dropped, on an H100 SXM at 700 W at the full
// image: the warpgroups taking turns to issue their products (named
// barriers, so one's softmax runs under the other's products), 4.30 ms
// against 4.12; a 4-stage ring, no faster than 3.
//
// Design, short bf16 (wgmma, sm_90a; redesigned after the first port, which
// swept K twice in each of 4 query-tile blocks of a (batch, head) and
// waited on its loads): a persistent block of two warpgroups on each SM
// walks the (batch, head) pairs. A pair's Q, K and V land in shared memory
// once, by cp.async, in 128-byte-swizzled rows of 64 values, in one of two
// stages, so the next pair's loads run under this pair's products. Each
// warpgroup takes every other 64-row query tile. S = Q K^T is wgmma
// m64n128k16 per 128-key chunk, Q and K both K-major from shared memory, S
// in registers (64 fp32 a thread a chunk). Up to 256 keys the whole score
// row stays in registers and the softmax is one exact pass: mask, the row
// max of the raw scores (scale > 0) over the lane quad, p = exp(s scale -
// max scale) as 2^(s c2 - max c2), c2 = scale log2(e), one FMA and one
// ex2.approx an element, the row sum, P normalized in fp32 and rounded to
// bf16, the rounding point of _short_kernel. P goes from the accumulators to the
// register A operand of wgmma m64n64k16 in their own layout, and V is the B
// operand as its rows stand (MN-major: the descriptor's transpose bit), so
// nothing is transposed. O is rounded to bf16, staged in the tile's Q rows
// and written in 16-byte stores. Past 256 keys (up to the route's 512) the
// row no longer fits and a pair takes all of shared memory: the first sweep
// over the chunks takes the row max and sum online, the second recomputes S
// and multiplies the normalized P by V, as the first port did.
//
// fp32 (no --amp): the tensor cores take no fp32 operands short of TF32,
// which would round where the plain version does not, so the same tiling
// runs on the FMA units: 256 threads, each 4 query rows x 8 keys of the
// scores (keys 16 apart) and 4 rows x 4 columns of the output; Q, K and V
// tiles in shared memory (rows padded to 272 B), P staged transposed in
// the K tile's place for P.V. Bound at the full image: 27.8 ms a call at
// 67 TFLOP/s fp32.
//
// Strides: q, k, v and out are addressed by (batch, head, row) strides in
// elements with contiguous 64-wide rows, so the head views of a joint qkv
// (B, L, 3D) need no copy and out can be written (B, L, H, 64).

#include <cmath>

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

#include "common.cuh"

namespace ebc {
namespace {

constexpr int kDh = 64;
constexpr int kBq = 64;   // query rows of a block
constexpr int kBk = 128;  // keys of a tile (JAX block_k)
constexpr int kFThreads = 256;  // fp32: 16 x 16 threads
constexpr int kFPitch = kDh + 4;  // fp32 Q, K and P^T row pitch

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

// Key tiles a query block starting at q0 visits: all of them, or, when
// causal, up to the one that holds its last row's own key.
__device__ __forceinline__ int key_tiles(const FlashArgs& a, int q0) {
  const int n = (a.lk + kBk - 1) / kBk;
  if (!a.causal) return n;
  const int last = min(q0 + kBq, a.lq) - 1;
  return min(n, last / kBk + 1);
}

__device__ __forceinline__ bool key_valid(const FlashArgs& a, int col, int row) {
  return col < a.lk && (!a.causal || col <= row);
}

// ---- bf16 short route (wgmma) ------------------------------------------------

constexpr int kSThreads = 256;  // two warpgroups
constexpr int kSChunk = 128;    // keys of one S = Q K^T wgmma (its N)
constexpr int kSRegChunks = 2;  // up to 256 keys the whole score row stays in registers
constexpr float kLog2e = 1.4426950408889634f;

// One stage: QT Q tiles of 64 rows, then K and V of KC chunks, rows of 128 B.
__host__ __device__ constexpr size_t short_stage_bytes(int kc, int qt) { return (size_t)(qt * kBq + 2 * kc * kSChunk) * 128; }
__host__ __device__ constexpr int short_stages(int kc, int qt) { return kc <= kSRegChunks && qt <= 4 ? 2 : 1; }
size_t short_smem_bytes(int kc, int qt) { return short_stages(kc, qt) * short_stage_bytes(kc, qt) + 1024; }

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
template <int KC>
__device__ __forceinline__ void short_tile(float (&o)[32], const FlashArgs& a, const unsigned char* qt,
                                           const unsigned char* ks, const unsigned char* vs, int r0,
                                           int t) {
  const float c2 = a.scale * kLog2e;
  // valid keys of rows r0 and r0 + 8: below lk, and up to the row when causal
  const int lim0 = a.causal ? min(a.lk, r0 + 1) : a.lk;
  const int lim1 = a.causal ? min(a.lk, r0 + 9) : a.lk;
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
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) short_exp(s[c], c2, -mx0 * c2, -mx1 * c2, l0, l1);
    quad_sum(l0, l1);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    uint32_t pa[KC][kSChunk / 16][4];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[c][i] *= (i & 2) ? inv1 : inv0;
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
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
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
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] *= (i & 2) ? inv1 : inv0;
      uint32_t pa[kSChunk / 16][4];
      short_pack(pa, s);
      wgmma_fence();
      short_pv(o, pa, vs + c * kSChunk * 128, c == 0);
      wgmma_commit();
      wgmma_wait<0>();
    }
  }
}

// Persistent: block i takes the (batch, head) pairs i, i + gridDim.x, ...;
// KC = ceil(lk / 128) key chunks, QT = Q tiles a stage holds (4 or 8).
template <int KC, int QT>
__global__ void __launch_bounds__(kSThreads, 1) flash_short_bf16_kernel(const FlashArgs a) {
  constexpr int kStages = short_stages(KC, QT);
  constexpr size_t kStage = short_stage_bytes(KC, QT);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_items = a.b * a.h, n_qt = (a.lq + kBq - 1) / kBq;

  // Q tiles, K and V of pair w into stage st, swizzled; rows past lq and
  // keys past lk zero (0 * V stays finite). Not committed.
  auto load = [&](int w, int st) {
    const int b = w / a.h, h = w % a.h;
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[1];
    const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + h * a.ks[1];
    const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + h * a.vs[1];
    unsigned char* qd = sm + st * kStage;
    unsigned char* kd = qd + QT * kBq * 128;
    unsigned char* vd = kd + KC * kSChunk * 128;
    for (int i = tid; i < n_qt * kBq * 8; i += kSThreads) {
      const int r = i >> 3, c = i & 7;
      const bool ok = r < a.lq;
      cp_async16(qd + sw128_offset(r, c), qb + (long long)(ok ? r : 0) * a.qs[2] + c * 8, ok);
    }
    for (int i = tid; i < KC * kSChunk * 8; i += kSThreads) {
      const int r = i >> 3, c = i & 7;
      const bool ok = r < a.lk;
      const long long kr = ok ? r : 0;
      cp_async16(kd + sw128_offset(r, c), kb + kr * a.ks[2] + c * 8, ok);
      cp_async16(vd + sw128_offset(r, c), vb + kr * a.vs[2] + c * 8, ok);
    }
  };

  const int first = blockIdx.x, step = gridDim.x;
  if (first < n_items) load(first, 0);
  cp_async_commit();
  int i = 0;
  for (int w = first; w < n_items; w += step, ++i) {
    const int st = kStages == 2 ? (i & 1) : 0;
    if (kStages == 2) {
      if (w + step < n_items) load(w + step, st ^ 1);  // lands while this pair computes
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();  // pair w landed for all

    const int b = w / a.h, h = w % a.h;
    bf16* ob = static_cast<bf16*>(a.o) + b * a.os[0] + h * a.os[1];
    unsigned char* qs = sm + st * kStage;
    const unsigned char* ks = qs + QT * kBq * 128;
    const unsigned char* vs = ks + KC * kSChunk * 128;
    for (int qt = wg; qt < n_qt; qt += 2) {  // warpgroup wg takes every other query tile
      unsigned char* q_tile = qs + qt * kBq * 128;
      const int rl = warp * 16 + g, r0 = qt * kBq + rl;
      float o[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) o[k] = 0.f;
      short_tile<KC>(o, a, q_tile, ks, vs, r0, t);
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
    __syncthreads();  // stage st is read: the pair after next may land in it
    if (kStages == 1) {
      if (w + step < n_items) load(w + step, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

template <int KC, int QT>
cudaError_t launch_short_bf16(const FlashArgs& a, int blocks, cudaStream_t st) {
  const size_t smem = short_smem_bytes(KC, QT);
  cudaError_t e = cudaFuncSetAttribute(flash_short_bf16_kernel<KC, QT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  flash_short_bf16_kernel<KC, QT><<<blocks, kSThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// One block an SM (or one a pair); the key chunks and the Q tiles pick the
// instantiation (the short route takes lq, lk <= 512).
cudaError_t launch_short_bf16_any(const FlashArgs& a, cudaStream_t st) {
  if (a.b < 1 || a.h < 1 || a.lq < 1 || a.lk < 1 || a.lq > 512 || a.lk > 512) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long items = (long long)a.b * a.h;
  const int blocks = (int)(items < sms ? items : sms);
  const bool long_q = a.lq > 4 * kBq;
  switch ((a.lk + kSChunk - 1) / kSChunk) {
    case 1: return long_q ? launch_short_bf16<1, 8>(a, blocks, st) : launch_short_bf16<1, 4>(a, blocks, st);
    case 2: return long_q ? launch_short_bf16<2, 8>(a, blocks, st) : launch_short_bf16<2, 4>(a, blocks, st);
    case 3: return long_q ? launch_short_bf16<3, 8>(a, blocks, st) : launch_short_bf16<3, 4>(a, blocks, st);
    default: return long_q ? launch_short_bf16<4, 8>(a, blocks, st) : launch_short_bf16<4, 4>(a, blocks, st);
  }
}

// ---- bf16 tiled route (wgmma, TMA, a producer warp) ---------------------------

constexpr int kTWarpgroups = 2;                      // consumers, 64 query rows each
constexpr int kTRows = kTWarpgroups * kBq;           // query rows of a block's item
constexpr int kTThreads = kTWarpgroups * 128 + 32;   // + one producer warp
constexpr int kTStages = 3;                          // K and V tiles in flight
constexpr int kTTile = kBk * 128;                    // bytes of a 128-key tile of K or V
constexpr int kTQBytes = kTRows * 128;               // bytes of a block's Q tile
constexpr int kTBarriers = 4 + 3 * kTStages;         // q full / empty x 2; k full, v full, kv empty
constexpr size_t kTSmem = 2 * kTQBytes + 2 * kTStages * kTTile + kTBarriers * 8 + 1024;

// Where the rows, heads and batch of a (64, rows, heads, batch) tensor map
// lie among its dims 1..3 (ordered by stride), for q, k and v.
struct TmaDims {
  int q[3], k[3], v[3];
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
// Waits until the phase of the given parity of ``bar`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

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

// Persistent: block i takes the items i, i + gridDim.x, ... of (128-row
// query tile, head, batch): query tiles fastest (a head's K and V stay in
// L2 while the card works on it), or, when causal, the longest tiles first.
__global__ void __launch_bounds__(kTThreads, 1)
flash_tiled_bf16_kernel(const FlashArgs a, const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                        const TmaDims dims) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qbuf = sm;                            // [2][kTQBytes]
  unsigned char* kbuf = qbuf + 2 * kTQBytes;           // [kTStages][kTTile]
  unsigned char* vbuf = kbuf + kTStages * kTTile;      // [kTStages][kTTile]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vbuf + kTStages * kTTile);  // [2]
  uint64_t* q_empty = q_full + 2;                      // [2]
  uint64_t* k_full = q_empty + 2;                      // [kTStages]
  uint64_t* v_full = k_full + kTStages;                // [kTStages]
  uint64_t* kv_empty = v_full + kTStages;              // [kTStages]
  constexpr int kConsumers = kTWarpgroups * 128;

  const int tid = threadIdx.x;
  const int n_qt = (a.lq + kTRows - 1) / kTRows, nk = (a.lk + kBk - 1) / kBk;
  const int n_hb = a.h * a.b, n_items = n_qt * n_hb;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], kConsumers);
    }
    for (int i = 0; i < kTStages; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&kv_empty[i], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // item w -> query tile, head, batch; and the key tiles the tile visits
  auto item = [&](int w, int& qt, int& h, int& b) {
    const int hb = a.causal ? w % n_hb : w / n_qt;
    qt = a.causal ? n_qt - 1 - w / n_hb : w % n_qt;
    h = hb % a.h;
    b = hb / a.h;
  };
  auto tiles_of = [&](int qt) {
    return a.causal ? min(nk, (min((qt + 1) * kTRows, a.lq) - 1) / kBk + 1) : nk;
  };

  // warp-uniform as the compiler sees it (a shuffle of lane 0's value), so
  // the consumers' wgmma do not lie on a divergent path
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == kTWarpgroups) {
    // the producer: one thread keeps Q (two buffers) and the K / V ring
    // filled, a stage refilled once both warpgroups have released it
    if (tid == kConsumers) {
      int t = 0, i = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++i) {
        int qt, h, b;
        item(w, qt, h, b);
        const int qb = i & 1;
        if (i >= 2) mbar_wait(&q_empty[qb], ((i >> 1) - 1) & 1);
        mbar_expect_tx(&q_full[qb], kTQBytes);
        tma_rows(qbuf + qb * kTQBytes, &tq, dims.q, qt * kTRows, h, b, &q_full[qb]);
        const int n = tiles_of(qt);
        for (int j = 0; j < n; ++j, ++t) {
          const int st = t % kTStages;
          if (t >= kTStages) mbar_wait(&kv_empty[st], (t / kTStages - 1) & 1);
          mbar_expect_tx(&k_full[st], kTTile);
          tma_rows(kbuf + st * kTTile, &tk, dims.k, j * kBk, h, b, &k_full[st]);
          mbar_expect_tx(&v_full[st], kTTile);
          tma_rows(vbuf + st * kTTile, &tv, dims.v, j * kBk, h, b, &v_full[st]);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. + 63 of each item
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float c2 = a.scale * kLog2e;
  int t = 0, i = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++i) {
    int qt, h, b;
    item(w, qt, h, b);
    const int qb = i & 1, n = tiles_of(qt);
    unsigned char* q_tile = qbuf + qb * kTQBytes + wg * kBq * 128;
    const int rl = warp * 16 + g, r0 = qt * kTRows + wg * kBq + rl;
    // valid keys of rows r0 and r0 + 8: below lk, and up to the row when causal
    const int lim0 = a.causal ? min(a.lk, r0 + 1) : a.lk;
    const int lim1 = a.causal ? min(a.lk, r0 + 9) : a.lk;
    float s[64], o[32];
    uint32_t pa[kBk / 16][4];
#pragma unroll
    for (int k = 0; k < 32; ++k) o[k] = 0.f;
    // running max of the raw scores (from -inf, as the TPU kernel's
    // scratch; scale > 0) and this thread's share of the row sums
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, al0, al1;
    // S_j's softmax in place: mask, m_next = max(m, rowmax), alpha =
    // exp(m - m_next), p = exp(s - m_next) in fp32 (scaled by c2 = scale
    // log2(e)), l = alpha l + sum p
    auto softmax = [&](int j) {
      float mx0 = m0, mx1 = m1;
      short_mask_max(s, j * kBk, lim0, lim1, t4, mx0, mx1);
      quad_max(mx0, mx1);
      al0 = fast_exp2((m0 - mx0) * c2);
      al1 = fast_exp2((m1 - mx1) * c2);
      float p0 = 0.f, p1 = 0.f;
      short_exp(s, c2, -mx0 * c2, -mx1 * c2, p0, p1);
      l0 = al0 * l0 + p0;
      l1 = al1 * l1 + p1;
      m0 = mx0;
      m1 = mx1;
    };
    mbar_wait(&q_full[qb], (i >> 1) & 1);

    // tile 0: S_0 and its softmax
    mbar_wait(&k_full[t % kTStages], (t / kTStages) & 1);
    wgmma_fence();
    short_scores(s, q_tile, kbuf + (t % kTStages) * kTTile);
    wgmma_commit();
    wgmma_wait<0>();
    softmax(0);
    short_pack(pa, s);
    // tile j: S_j = Q K_j^T is issued, then P_{j-1} V_{j-1}; the softmax of
    // S_j runs while that product is in flight (every wait on a barrier
    // comes before the wgmma fence, so nothing divergent lies between the
    // products and their waits)
    for (int j = 1; j < n; ++j) {
      const int st = (t + 1) % kTStages, sp = t % kTStages;
      mbar_wait(&k_full[st], ((t + 1) / kTStages) & 1);
      mbar_wait(&v_full[sp], (t / kTStages) & 1);
        wgmma_fence();
      short_scores(s, q_tile, kbuf + st * kTTile);
      wgmma_commit();
      short_pv(o, pa, vbuf + sp * kTTile, false);
      wgmma_commit();
        wgmma_wait<1>();  // S_j is done
      softmax(j);
      wgmma_wait<0>();  // P_{j-1} V_{j-1} is done: o and pa are free, stage sp is read
      mbar_arrive(&kv_empty[sp]);
      ++t;
      // acc = acc alpha + bf16(p) V: the rescale here, the product next tile
#pragma unroll
      for (int k = 0; k < 32; ++k) o[k] *= (k & 2) ? al1 : al0;
      short_pack(pa, s);
    }
    const int sp = t % kTStages;
    mbar_wait(&v_full[sp], (t / kTStages) & 1);
    wgmma_fence();
    short_pv(o, pa, vbuf + sp * kTTile, false);
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&kv_empty[sp]);
    ++t;

    // acc (1 / l), 1 where l == 0, rounded to bf16 and staged swizzled in
    // this warpgroup's Q rows (its products are done), then 16-byte stores
    quad_sum(l0, l1);
    const float inv0 = l0 == 0.f ? 1.f : 1.f / l0, inv1 = l1 == 0.f ? 1.f : 1.f / l1;
#pragma unroll
    for (int jj = 0; jj < kDh / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(q_tile + sw128_offset(rl, jj) + 4 * t4) =
          pack_bf16(o[4 * jj] * inv0, o[4 * jj + 1] * inv0);
      *reinterpret_cast<uint32_t*>(q_tile + sw128_offset(rl + 8, jj) + 4 * t4) =
          pack_bf16(o[4 * jj + 2] * inv1, o[4 * jj + 3] * inv1);
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");  // this warpgroup only
    bf16* ob = static_cast<bf16*>(a.o) + b * a.os[0] + h * a.os[1];
    for (int k = tid & 127; k < kBq * 8; k += 128) {
      const int r = k >> 3, c = k & 7, row = qt * kTRows + wg * kBq + r;
      if (row < a.lq)
        *reinterpret_cast<uint4*>(ob + row * a.os[2] + c * 8) =
            *reinterpret_cast<const uint4*>(q_tile + sw128_offset(r, c));
    }
    fence_proxy_async();  // these reads and writes before the next TMA write into the buffer
    mbar_arrive(&q_empty[qb]);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the CUDA runtime (no -lcuda).
EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map of (64, rows, heads, batch) at ptr with (batch, head,
// row) strides st in elements, dims 1..3 ordered by stride; boxes of 64 x
// box_rows, 128B-swizzled (the layout sw128_desc reads). pos gets where
// rows, heads and batch went.
cudaError_t encode_rows_map(CUtensorMap* map, int (&pos)[3], const void* ptr, int rows, int h, int b,
                            const long long (&st)[3], int box_rows) {
  const EncodeTiledFn enc = tensor_map_encoder();
  if (!enc) return cudaErrorNotSupported;
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
  cuuint32_t box[4] = {(cuuint32_t)kDh, 1, 1, 1}, elem[4] = {1, 1, 1, 1};
  for (int x = 0; x < 3; ++x) {
    const int which = order[x];
    dims[x + 1] = extent[which];
    strides[x] = (cuuint64_t)stride[which] * sizeof(bf16);
    box[x + 1] = which == 0 ? (cuuint32_t)box_rows : 1u;
    pos[which] = x + 1;
  }
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                         box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_tiled_bf16(const FlashArgs& a, cudaStream_t st) {
  if (a.b < 1 || a.h < 1 || a.lq < 1 || a.lk < 1) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  TmaDims dims;
  cudaError_t e = encode_rows_map(&tq, dims.q, a.q, a.lq, a.h, a.b, a.qs, kTRows);
  if (e == cudaSuccess) e = encode_rows_map(&tk, dims.k, a.k, a.lk, a.h, a.b, a.ks, kBk);
  if (e == cudaSuccess) e = encode_rows_map(&tv, dims.v, a.v, a.lk, a.h, a.b, a.vs, kBk);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_tiled_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTSmem);
  if (e != cudaSuccess) return e;
  const long long items = (long long)((a.lq + kTRows - 1) / kTRows) * a.h * a.b;
  const int blocks = (int)(items < sms ? items : sms);
  flash_tiled_bf16_kernel<<<blocks, kTThreads, kTSmem, st>>>(a, tq, tk, tv, dims);
  return cudaGetLastError();
}

// ---- fp32 (FMA units) --------------------------------------------------------

size_t f32_smem_bytes() { return (size_t)(kBq * kFPitch + kBk * kFPitch + kBk * kDh) * sizeof(float); }

// Scores of this thread's rows 4 ty + i against keys tx + 16 j of the tile.
__device__ __forceinline__ void f32_scores(float (&s)[4][8], const float* qs, const float* kt,
                                           int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kDh; d += 4) {
    float4 qv[4], kv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * kFPitch + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) kv[j] = *reinterpret_cast<const float4*>(kt + (tx + 16 * j) * kFPitch + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
      }
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

template <bool kShort>
__global__ void __launch_bounds__(kFThreads) flash_f32_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                    // [kBq][kFPitch]
  float* kt = qs + kBq * kFPitch;     // [kBk][kFPitch]: K, then P^T
  float* vt = kt + kBk * kFPitch;     // [kBk][kDh]

  const int q0 = blockIdx.x * kBq, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* qb = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* kb = static_cast<const float*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const float* vb = static_cast<const float*>(a.v) + b * a.vs[0] + h * a.vs[1];
  float* ob = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1];
  const int n_tiles = key_tiles(a, q0);

  for (int i = tid; i < kBq * (kDh / 4); i += kFThreads) {
    const int r = i >> 4, c = (i & 15) * 4, row = q0 + r;
    const bool ok = row < a.lq;
    cp_async16(qs + r * kFPitch + c, qb + (long long)(ok ? row : 0) * a.qs[2] + c, ok);
  }
  cp_async_commit();

  auto load = [&](int tile, bool with_v) {
    for (int i = tid; i < kBk * (kDh / 4); i += kFThreads) {
      const int r = i >> 4, c = (i & 15) * 4, key = tile * kBk + r;
      const bool ok = key < a.lk;
      const long long kr = ok ? key : 0;
      cp_async16(kt + r * kFPitch + c, kb + kr * a.ks[2] + c, ok);
      if (with_v) cp_async16(vt + r * kDh + c, vb + kr * a.vs[2] + c, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };

  // x scale (unless 1) and mask in place; returns the tile's row maxima
  auto scale_mask = [&](float (&s)[4][8], int k0, float (&mx)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float m = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (a.scale != 1.f) s[i][j] *= a.scale;
        s[i][j] = key_valid(a, k0 + tx + 16 * j, row) ? s[i][j] : kNegInf;
        m = fmaxf(m, s[i][j]);
      }
      mx[i] = half_max(m);
    }
  };

  float s[4][8], mx[4];
  float o[4][4] = {};
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY}, l[4] = {0.f, 0.f, 0.f, 0.f};

  if (kShort) {
    for (int it = 0; it < n_tiles; ++it) {
      load(it, false);
      f32_scores(s, qs, kt, tx, ty);
      scale_mask(s, it * kBk, mx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mn = fmaxf(m[i], mx[i]);
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) p += expf(s[i][j] - mn);
        l[i] = expf(m[i] - mn) * l[i] + p;
        m[i] = mn;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) l[i] = half_sum(l[i]);
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBk;
    load(it, true);
    f32_scores(s, qs, kt, tx, ty);
    scale_mask(s, k0, mx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kShort) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = expf(s[i][j] - m[i]) / l[i];
      } else {
        const float mn = fmaxf(m[i], mx[i]), al = expf(m[i] - mn);
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = expf(s[i][j] - mn);
          p += s[i][j];
        }
        l[i] = al * l[i] + p;
        m[i] = mn;
#pragma unroll
        for (int c = 0; c < 4; ++c) o[i][c] *= al;
      }
    }
    __syncthreads();  // every thread's scores are read: P^T takes K's place
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(kt + (tx + 16 * j) * kFPitch + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
    const int nk = min(kBk, a.lk - k0);
    for (int key = 0; key < nk; ++key) {
      const float4 p = *reinterpret_cast<const float4*>(kt + key * kFPitch + 4 * ty);
      const float4 v = *reinterpret_cast<const float4*>(vt + key * kDh + 4 * tx);
      const float pv[4] = {p.x, p.y, p.z, p.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    float inv = 1.f;
    if (!kShort) {
      const float lt = half_sum(l[i]);
      inv = lt == 0.f ? 1.f : 1.f / lt;
    }
    if (row < a.lq)
      *reinterpret_cast<float4*>(ob + row * a.os[2] + 4 * tx) =
          make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv, o[i][3] * inv);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const FlashArgs& a, cudaStream_t st) {
  if (a.b < 1 || a.h < 1 || a.lq < 1 || a.lk < 1 || a.b > 65535 || a.h > 65535)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.lq + kBq - 1) / kBq, a.h, a.b);
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

FlashArgs make_args(const void* q, const void* k, const void* v, void* o, int b, int h, int lq,
                    int lk, const long long (&st)[12], float scale, int causal) {
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.b = b;
  a.h = h;
  a.lq = lq;
  a.lk = lk;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = st[i];
    a.ks[i] = st[3 + i];
    a.vs[i] = st[6 + i];
    a.os[i] = st[9 + i];
  }
  a.scale = scale;
  a.causal = causal;
  return a;
}

}  // namespace
}  // namespace ebc

// Each entry: q (B, H, Lq, 64), k and v (B, H, Lk, 64), out (B, H, Lq, 64),
// all bf16 (or all fp32 for the _f32 entries), addressed by the (batch,
// head, row) strides in elements that follow (q, k, v, out in turn); rows
// contiguous and 16-byte aligned. Returns the CUDA error code of the launch
// (0 = ok).
#define EBC_FLASH_ENTRY(NAME, LAUNCH)                                                              \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, int b, int h, int lq, \
                      int lk, long long qsb, long long qsh, long long qsr, long long ksb,           \
                      long long ksh, long long ksr, long long vsb, long long vsh, long long vsr,    \
                      long long osb, long long osh, long long osr, float scale, int causal,         \
                      void* stream) {                                                               \
    using namespace ebc;                                                                            \
    const long long st[12] = {qsb, qsh, qsr, ksb, ksh, ksr, vsb, vsh, vsr, osb, osh, osr};          \
    const FlashArgs args = make_args(q, k, v, o, b, h, lq, lk, st, scale, causal);                 \
    const cudaStream_t cs = static_cast<cudaStream_t>(stream);                                      \
    return (int)(LAUNCH);                                                                           \
  }

EBC_FLASH_ENTRY(ebc_flash_short, launch_short_bf16_any(args, cs))
EBC_FLASH_ENTRY(ebc_flash_tiled, launch_tiled_bf16(args, cs))
EBC_FLASH_ENTRY(ebc_flash_short_f32, launch(flash_f32_kernel<true>, kFThreads, f32_smem_bytes(), args, cs))
EBC_FLASH_ENTRY(ebc_flash_tiled_f32, launch(flash_f32_kernel<false>, kFThreads, f32_smem_bytes(), args, cs))
