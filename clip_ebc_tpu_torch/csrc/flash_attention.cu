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
// Short route (both dtypes): the bodies of csrc/attention_short.cuh with
// P normalized before P V. bf16: a persistent wgmma block stages a (batch,
// head) pair's Q, K and V once (redesigned after the first port, which
// swept K twice in each of 4 query-tile blocks of a pair and waited on its
// loads). fp32: register-blocked SIMT, a block per (64-query tile, head,
// batch) with the whole score row in registers (redesigned after the first
// port, which swept K twice in 128-key tiles, each loaded, waited on and
// then used, 4 rows x 8 keys a thread with an expf and a division an
// element in the second sweep: 1.29 ms at the windows' shape).
//
// Tiled fp32 (no --amp): the tensor cores take no fp32 operands short of
// TF32, which would round where the plain version does not, so the tiled
// route runs on the FMA units: 256 threads, each 4 query rows x 8 keys of
// the scores (keys 16 apart) and 4 rows x 4 columns of the output; Q, K
// and V tiles in shared memory (rows padded to 272 B), P staged transposed
// in the K tile's place for P.V. Bound at the full image: 27.8 ms a call at
// 67 TFLOP/s fp32.
//
// Strides: q, k, v and out are addressed by (batch, head, row) strides in
// elements with contiguous 64-wide rows, so the head views of a joint qkv
// (B, L, 3D) need no copy and out can be written (B, L, H, 64).

#include <cmath>

#include "attention_short.cuh"

namespace ebc {
namespace {

constexpr int kBk = 128;  // keys of a tile (JAX block_k)
constexpr int kFThreads = 256;  // fp32: 16 x 16 threads
constexpr int kFPitch = kDh + 4;  // fp32 Q, K and P^T row pitch

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

// ---- bf16 tiled route (wgmma, TMA, a producer warp) ---------------------------

constexpr int kTWarpgroups = 2;                      // consumers, 64 query rows each
constexpr int kTRows = kTWarpgroups * kBq;           // query rows of a block's item
constexpr int kTThreads = kTWarpgroups * 128 + 32;   // + one producer warp
constexpr int kTStages = 3;                          // K and V tiles in flight
constexpr int kTTile = kBk * 128;                    // bytes of a 128-key tile of K or V
constexpr int kTQBytes = kTRows * 128;               // bytes of a block's Q tile
constexpr int kTBarriers = 4 + 3 * kTStages;         // q full / empty x 2; k full, v full, kv empty
constexpr size_t kTSmem = 2 * kTQBytes + 2 * kTStages * kTTile + kTBarriers * 8 + 1024;

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

cudaError_t launch_tiled_bf16(const FlashArgs& a, cudaStream_t st) {
  if (a.b < 1 || a.h < 1 || a.lq < 1 || a.lk < 1) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  TmaDims dims;
  cudaError_t e = encode_rows_map(&tq, dims.q, a.q, a.lq, a.h, a.b, a.qs, kTRows);
  if (e == cudaSuccess) e = encode_rows_map(&tk, dims.k, a.k, a.lk, a.h, a.b, a.ks, kBk);
  if (e == cudaSuccess) e = encode_rows_map(&tv, dims.v, a.v, a.lk, a.h, a.b, a.vs, kBk);
  const int sms = sm_count();
  if (e == cudaSuccess && sms < 1) e = cudaErrorInvalidDevice;
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

__global__ void __launch_bounds__(kFThreads) flash_tiled_f32_kernel(const FlashArgs a) {
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

  auto load = [&](int tile) {
    for (int i = tid; i < kBk * (kDh / 4); i += kFThreads) {
      const int r = i >> 4, c = (i & 15) * 4, key = tile * kBk + r;
      const bool ok = key < a.lk;
      const long long kr = ok ? key : 0;
      cp_async16(kt + r * kFPitch + c, kb + kr * a.ks[2] + c, ok);
      cp_async16(vt + r * kDh + c, vb + kr * a.vs[2] + c, ok);
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

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBk;
    load(it);
    f32_scores(s, qs, kt, tx, ty);
    scale_mask(s, k0, mx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
    const float lt = half_sum(l[i]);
    const float inv = lt == 0.f ? 1.f : 1.f / lt;
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

// The short route takes lq, lk <= 512 (4 key chunks; NJ up to 32).
EBC_FLASH_ENTRY(ebc_flash_short, (launch_short_bf16_any<false, 4>(args, cs)))
EBC_FLASH_ENTRY(ebc_flash_tiled, launch_tiled_bf16(args, cs))
EBC_FLASH_ENTRY(ebc_flash_short_f32, (launch_short_f32_any<false, 32>(args, cs)))
EBC_FLASH_ENTRY(ebc_flash_tiled_f32, launch(flash_tiled_f32_kernel, kFThreads, f32_smem_bytes(), args, cs))
