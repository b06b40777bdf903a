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
// = 1.86 TFLOP of QK^T and PV a call against ~30 MB of q, k, v and out:
// 1.88 ms of bf16 tensor-core work (989 TFLOP/s) against 0.009 ms of memory,
// so operations bound the tiled route and the design keeps the tensor cores
// fed from shared memory. The short route at the windows' shape (B = 140,
// L = 229) does 22.6 GFLOP against 197 MB: bytes bound it (0.059 ms).
//
// Design, tiled bf16 (mma.sync m16n8k16, the layout of mha_kernel in
// fused_attention.cu): one block of 4 warps per (64-query tile, head,
// batch), each warp 16 query rows whose Q fragments stay in registers. K and
// V tiles of 128 keys (the JAX block_k, so the online softmax rescales at
// the same keys as the TPU kernel) go through a 2-stage cp.async ring in
// shared memory (rows padded to 144 B: ldmatrix rows hit distinct banks).
// K in its (L, 64) row layout is the column-major B operand of Q K^T as it
// stands; V goes through ldmatrix.trans. The scores of a warp's 16 rows x
// 128 keys are 64 fp32 accumulators a thread; the row max and sum are
// quad shuffles; P is rounded to bf16 in registers and is the A operand of
// P.V as it stands.
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

#include "common.cuh"

namespace ebc {
namespace {

constexpr int kDh = 64;
constexpr int kBq = 64;   // query rows of a block
constexpr int kBk = 128;  // keys of a tile (JAX block_k)
constexpr int kThreads = 128;  // bf16: 4 warps of 16 query rows
constexpr int kLdh = kDh + 8;  // bf16 K/V row pitch in shared memory
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

// ---- bf16 (tensor cores) -----------------------------------------------------

size_t bf16_smem_bytes() { return (size_t)2 * 2 * kBk * kLdh * sizeof(bf16); }

// Scores of the warp's 16 rows against the 128 keys of tile kt (row pitch
// kLdh): s[j] holds keys 8j..8j+7.
__device__ __forceinline__ void tile_scores(float (&s)[kBk / 8][4], const uint32_t (&qa)[kDh / 16][4],
                                            const bf16* kt, int lane) {
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < kBk / 16; ++j) {
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      uint32_t kb[4];  // key groups 2j and 2j+1: {b0, b1} each
      ldmatrix_x4(kb, kt + (size_t)(j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdh + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * j], qa[kk], kb[0], kb[1]);
      mma_bf16(s[2 * j + 1], qa[kk], kb[2], kb[3]);
    }
  }
}

// x scale (unless 1), mask, and the tile's max of rows g and g + 8 over
// the lane quad.
__device__ __forceinline__ void scale_mask_max(float (&s)[kBk / 8][4], const FlashArgs& a, int k0,
                                               int r0, int t, float& mx0, float& mx1) {
  mx0 = kNegInf;
  mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + j * 8 + 2 * t + e;
      if (a.scale != 1.f) {
        s[j][e] *= a.scale;
        s[j][2 + e] *= a.scale;
      }
      s[j][e] = key_valid(a, col, r0) ? s[j][e] : kNegInf;
      s[j][2 + e] = key_valid(a, col, r0 + 8) ? s[j][2 + e] : kNegInf;
      mx0 = fmaxf(mx0, s[j][e]);
      mx1 = fmaxf(mx1, s[j][2 + e]);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
}

// o += bf16(P) V over the 128 keys of the V tile vt.
__device__ __forceinline__ void tile_pv(float (&o)[kDh / 8][4], const float (&s)[kBk / 8][4],
                                        const bf16* vt, int lane) {
#pragma unroll
  for (int j = 0; j < kBk / 16; ++j) {
    const uint32_t pa[4] = {
        pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
        pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]), pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
    for (int dn = 0; dn < kDh / 16; ++dn) {
      uint32_t vb[4];  // dh groups 2dn and 2dn+1: {b0, b1} each
      ldmatrix_x4_trans(vb, vt + (size_t)(j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdh +
                                dn * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dn], pa, vb[0], vb[1]);
      mma_bf16(o[2 * dn + 1], pa, vb[2], vb[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) flash_tiled_bf16_kernel(const FlashArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [2][kBk][kLdh]
  bf16* vs = ks + 2 * kBk * kLdh;            // [2][kBk][kLdh]

  const int q0 = blockIdx.x * kBq, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + h * a.ks[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + h * a.vs[1];
  bf16* ob = static_cast<bf16*>(a.o) + b * a.os[0] + h * a.os[1];
  const int n_tiles = key_tiles(a, q0);

  // one tile of K (and V) into ring stage st; keys >= lk are zero-filled so
  // 0 * V stays finite
  auto load = [&](int tile, int st, bool with_v) {
    bf16* kd = ks + st * kBk * kLdh;
    bf16* vd = vs + st * kBk * kLdh;
    for (int i = tid; i < kBk * (kDh / 8); i += kThreads) {
      const int r = i >> 3, c = (i & 7) * 8, key = tile * kBk + r;
      const bool ok = key < a.lk;
      const long long kr = ok ? key : 0;
      cp_async16(kd + r * kLdh + c, kb + kr * a.ks[2] + c, ok);
      if (with_v) cp_async16(vd + r * kLdh + c, vb + kr * a.vs[2] + c, ok);
    }
    cp_async_commit();
  };

  // Q fragments of the warp's 16 rows, straight from device memory
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < a.lq ? *reinterpret_cast<const uint32_t*>(qb + r0 * a.qs[2] + c) : 0u;
    qa[kk][1] = r1 < a.lq ? *reinterpret_cast<const uint32_t*>(qb + r1 * a.qs[2] + c) : 0u;
    qa[kk][2] = r0 < a.lq ? *reinterpret_cast<const uint32_t*>(qb + r0 * a.qs[2] + c + 8) : 0u;
    qa[kk][3] = r1 < a.lq ? *reinterpret_cast<const uint32_t*>(qb + r1 * a.qs[2] + c + 8) : 0u;
  }

  float s[kBk / 8][4];
  float o[kDh / 8][4];
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  // running row max (from -inf, as the TPU kernel's scratch) and this
  // thread's share of the row sum, rows g and g + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // the online softmax over the key tiles
  load(0, 0, true);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load(it + 1, (it + 1) & 1, true);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = it & 1;
    tile_scores(s, qa, ks + st * kBk * kLdh, lane);
    float mx0, mx1;
    scale_mask_max(s, a, it * kBk, r0, t, mx0, mx1);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      p0 += s[j][0] + s[j][1];
      p1 += s[j][2] + s[j][3];
    }
    l0 = al0 * l0 + p0;
    l1 = al1 * l1 + p1;
#pragma unroll
    for (int i = 0; i < kDh / 8; ++i) {
      o[i][0] *= al0;
      o[i][1] *= al0;
      o[i][2] *= al1;
      o[i][3] *= al1;
    }
    m0 = mn0;
    m1 = mn1;
    tile_pv(o, s, vs + st * kBk * kLdh, lane);
    __syncthreads();
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0, inv1 = l1 == 0.f ? 1.f : 1.f / l1;
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i) {
    const int c = i * 8 + 2 * t;
    if (r0 < a.lq)
      *reinterpret_cast<uint32_t*>(ob + r0 * a.os[2] + c) = pack_bf16(o[i][0] * inv0, o[i][1] * inv0);
    if (r1 < a.lq)
      *reinterpret_cast<uint32_t*>(ob + r1 * a.os[2] + c) = pack_bf16(o[i][2] * inv1, o[i][3] * inv1);
  }
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
EBC_FLASH_ENTRY(ebc_flash_tiled, launch(flash_tiled_bf16_kernel, kThreads, bf16_smem_bytes(), args, cs))
EBC_FLASH_ENTRY(ebc_flash_short_f32, launch(flash_f32_kernel<true>, kFThreads, f32_smem_bytes(), args, cs))
EBC_FLASH_ENTRY(ebc_flash_tiled_f32, launch(flash_f32_kernel<false>, kFThreads, f32_smem_bytes(), args, cs))
