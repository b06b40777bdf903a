// Backward of the trunk's masked attention, and of LayerNorm + joint QKV
// projection + attention with frozen LN and projection (the VPT trunk):
// ports of the Pallas kernels in clip_ebc_tpu/ops/fused_attention.py.
//
//  * ebc_attention_bwd / ebc_attention_bwd_f32 replace _attention_bwd
//    (pallas_call at :360, body _pair_attention_bwd_body :267): d_qkv
//    (B, L, 3D) from qkv (B, L, 3D) and the output cotangent g (B, L, D).
//  * ebc_ln_bwd_dx replaces the tail of _ln_qkv_bwd_frozen_kernel (:564,
//    pallas_call at :627): dy = d_qkv . W, then the LayerNorm backward
//    for dx only. The wrapper (ops/fused_attention.py ln_qkv_bwd_frozen)
//    runs the whole frozen backward as three launches: the forward's
//    ln_qkv_proj_kernel recomputes qkv (csrc/fused_attention.cu), then
//    ebc_attention_bwd, then ebc_ln_bwd_dx.
//
// Rounding points are the JAX body's: fp32 scores x sm_scale, keys >=
// kv_len at kNegInf, softmax over the whole row with the global row max
// and sum, P NORMALIZED in fp32 and only then rounded to the activation
// dtype (unlike the forward, which rounds unnormalized P), dS = P (dP -
// rowsum(dP P)) sm_scale rounded, dQ = dS K, dK = dS^T Q, dV = P^T g in
// fp32 accumulators stored in the activation dtype. Masked key columns
// have P = 0 exactly, so no gradient reaches a padded key.
//
// Bound, at the flagship training shape (B = 16 windows, L = 229, D = 768,
// 12 heads; H100 SXM, 700 W): the attention backward must read qkv 16.9 MB
// and g 5.6 MB and write d_qkv 16.9 MB (0.012 ms at 3.35 TB/s) for 6.4
// GFLOP of products (0.0065 ms at 989 TFLOP/s bf16): bytes bound it in
// bf16; in fp32 the same FLOP over 67 TFLOP/s is 0.096 ms, so operations
// do. dy = d_qkv . W is M = 3664 x K = 2304 x N = 768 (13.0 GFLOP); with
// the recomputed projection and the attention the frozen backward is 32.4
// GFLOP, 0.033 ms at 989 TFLOP/s: operations bound it.
//
// Design, bf16 (wgmma, TMA, sm_90a; one launch, attn_bwd_bf16_kernel;
// redesigned after the first port, two mma.sync launches over (64-row
// tile, head, window) blocks of 4 warps that each restaged the head's K
// and V, or Q and g, and passed each row's max, sum and D through an fp32
// scratch; S was computed four times and dP twice: 0.143 ms at the
// flagship training shape, 2.6x the SDPA backward):
//  * one block of two warpgroups per (window, head): its Q, K, V and g
//    (4 x L x 64 bf16, 117 KB at L = 229; rows padded to 64 land as zeros)
//    come by TMA once, in 64-row boxes of the (window, head, row)-strided
//    views of qkv and g (128B-swizzled), Q and K on one mbarrier and V and
//    g on a second, so the first products start before V and g land. Each
//    pair is staged once, where the first port staged each head 4 times in
//    each of two launches, and nothing goes through device memory between
//    the row and key passes (the fp32 scratch and the second launch are
//    gone). The card holds one block an SM (its shared memory), 192 blocks
//    at B = 16 on 132 SMs; a pair's query tiles split over two blocks, as
//    the forward body does at small batch, would have each block recompute
//    every row's statistics, about as much work again as it saves.
//  * rows: a warpgroup takes a 64-row query tile. S = Q K^T for all key
//    chunks holding a valid key (wgmma m64n64k16, both operands K-major in
//    shared memory) stays in registers (up to 320 keys: 160 a thread), so
//    the softmax is exact over the row in one pass: keys >= kv_len at
//    kNegInf, the max of the raw scores (scale > 0), p = 2^(s c2 - max c2)
//    (c2 = scale log2(e), ex2.approx) / sum in fp32. dP = g V^T chunk by
//    chunk gives D = rowsum(dP P); dP is computed again with dS = P (dP -
//    D) scale, rounded to bf16 from the accumulators into the register A
//    operand of dQ += dS K (K the MN-major B operand as its rows stand),
//    the next chunk's dP issued with it. Each row's (max c2, 1 / sum, D)
//    goes to shared memory; dQ is staged and written in 16-byte stores.
//  * keys, after one block barrier: a warpgroup takes a 64-key slice and
//    holds its dK and dV accumulators over the query tiles. S^T = K Q^T and
//    dP^T = V g^T (K-major from shared memory) put keys on the rows, so P^T
//    = 2^(s c2 - max_q c2) / sum_q (the rows' statistics, the same
//    operations as the row pass, hence the same p) and dS^T = P^T (dP^T -
//    D_q) scale come out of the accumulators in the register A layout of
//    dV += P^T g and dK += dS^T Q (g and Q MN-major), with no transpose
//    through shared memory; the next tile's S^T and dP^T are issued with
//    this tile's dV and dK products. Slices past kv_len are zeros. Every
//    wgmma group is waited on before its registers are read and before the
//    next loop turn (ptxas serializes every wgmma otherwise).
//  * S is computed twice (row and key passes) and dP three times: 8
//    products of 64 x L x L against the 5 a single pass needs; the
//    register budget (255 a thread with two warpgroups) rules out holding
//    dK and dV of every key beside the row pass's P.
//  * fp32 (training without --amp; redesigned after the first port, a warp
//    a row reading one shared-memory operand per FMA): two launches, one
//    for the rows and one for the keys, with the rows' statistics passed
//    through an fp32 scratch, in register-blocked SIMT fp32 (the tensor
//    cores take no fp32 short of TF32, which would round where the plain
//    version does not).
//    attn_bwd_dq_f32_kernel: one block of 8 warps per (64-query tile, head,
//    window) with the tile's Q and g rows and all of K_h and V_h in shared
//    memory (rows padded to 68 floats, so a quarter warp's float4 reads of 8
//    rows hit distinct banks). A warp owns 8 query rows, a lane keys lane +
//    32 j, so the whole row (up to 320 keys, 10 a lane) stays in registers:
//    S and dP in one pass, each float4 of K or V feeding 32 FMAs of the 8
//    rows, whose float4s are broadcast; the softmax is exact over the row
//    (warp shuffles), then dS = P (dP - D) sm_scale. dS^T goes to shared
//    memory in V's place and dQ = dS K is 4 x 4 outputs a thread.
//    attn_bwd_dkv_f32_kernel: one block per (64-key tile, head, window),
//    the same layout with keys for queries, the queries in chunks of 128: a
//    warp owns 8 keys, a lane queries lane + 32 j; S^T and dP^T, P^T and
//    dS^T from the row statistics, both written transposed, then dV += P^T
//    g and dK += dS^T Q, 4 x 4 outputs of each a thread. S and dP are
//    computed twice (once a launch), 1.7x the FLOP of one pass; a single
//    launch has not been tried against this split.
//  * ln_bwd_dx_kernel: a block owns 32 rows x all D columns of dy (8
//    warps, each 32 rows x D/8 columns, mma.sync from shared memory), so
//    the LayerNorm's row means of dy gamma and dy gamma xhat close inside
//    the block; d_qkv tiles (32 x 32) and W tiles (32 x D) stream through a
//    3-stage cp.async ring. The LN statistics are taken from x in the
//    prologue while the first tiles land. Only dx is written.
//  * Costs to remove later: qkv and d_qkv each make a round trip through
//    device memory (16.9 MB each per layer at the flagship shape), which
//    the Pallas kernel kept in VMEM.
//
// Limits: head dim 64; L <= 320; the LN backward needs D % 128 == 0 and D
// <= 768 (the W tiles fill shared memory).

#include "attention_short.cuh"

namespace ebc {
namespace {

constexpr int kMaxL = 320;

// ---- bf16 (wgmma, TMA, one launch) -------------------------------------------

constexpr int kBWarpgroups = 2;
constexpr int kBThreads = kBWarpgroups * 128;
constexpr int kBTile = kBq * 128;  // bytes of a 64-row tile of Q, K, V or g (rows of 64 values)

// Where the rows, heads and batch of the q, k, v and g tensor maps lie.
struct BwdDims {
  int q[3], k[3], v[3], g[3];
};

// Q, K, V and g of a (window, head), LP rows each; a staged output tile per
// warpgroup; each row's max x c2, 1 / sum and D; two barriers; alignment.
inline size_t bwd_smem_bytes(int lp) {
  return (size_t)4 * lp * 128 + (size_t)kBWarpgroups * kBTile + (size_t)lp * sizeof(float4) + 16 + 1024;
}

// d (64 x 64 fp32) (+)= A (64 x 16 bf16) . B (16 x 64 bf16), both K-major in
// shared memory (128B-swizzled rows of 64 values).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Issues d = A . B^T over the head dim (no commit): the 64 rows at ``a``
// against the 64 rows at ``b``. Thread i of the warpgroup holds rows 16 (i /
// 32) + g and + 8 of A, rows 8 j + 2t, + 1 of B in d[4 j .. 4 j + 3].
__device__ __forceinline__ void bwd_dot(float (&d)[32], const unsigned char* a, const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) wgmma_m64n64k16_ss(d, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32), kk > 0);
}

// Issues d (+)= A . B (no commit): A 64 x 64 bf16 in registers (4 steps of
// 16), B the 64 rows at ``b`` as they stand (MN-major).
__device__ __forceinline__ void bwd_mul(float (&d)[32], const uint32_t (&pa)[4][4], const unsigned char* b,
                                        bool first) {
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_m64n64k16_rs(d, pa[k], sw128_desc(b + k * 16 * 128), !first || k > 0);
}

// A 64-column accumulator tile rounded to bf16 in the register A operand
// layout of its 4 16-column steps: the accumulators as they lie.
__device__ __forceinline__ void bwd_pack(uint32_t (&pa)[4][4], const float (&p)[32]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pa[k][0] = pack_bf16(p[8 * k], p[8 * k + 1]);
    pa[k][1] = pack_bf16(p[8 * k + 2], p[8 * k + 3]);
    pa[k][2] = pack_bf16(p[8 * k + 4], p[8 * k + 5]);
    pa[k][3] = pack_bf16(p[8 * k + 6], p[8 * k + 7]);
  }
}

// One block (two warpgroups) per (window, head): the pair's Q, K, V and g
// land once by TMA (rows past l as zeros), then
//  1. the rows: warpgroup wg takes query tiles wg, wg + 2, ...: three
//     sweeps over the 64-key chunks holding a valid key (the row max and
//     sum online; D = rowsum(dP P); dS and dQ += dS K), then dQ out and
//     the rows' max, 1 / sum and D into shared memory;
//  2. the keys: warpgroup wg takes key slices wg, wg + 2, ...: over the
//     query tiles S^T = K Q^T and dP^T = V g^T, P^T and dS^T from the row
//     statistics, dV += P^T g and dK += dS^T Q, then dK and dV out.
template <int NKC>
__global__ void __launch_bounds__(kBThreads, 1)
attn_bwd_bf16_kernel(bf16* __restrict__ dqkv, int l, int num_heads, int kv_len, float sm_scale,
                     const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                     const BwdDims dims) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int n_t = (l + kBq - 1) / kBq, lp = n_t * kBq;
  unsigned char* qs = sm;
  unsigned char* ks = qs + lp * 128;
  unsigned char* vs = ks + lp * 128;
  unsigned char* gs = vs + lp * 128;
  unsigned char* stage = gs + lp * 128;                             // [kBWarpgroups][kBTile]
  // each row's (max x c2, 1 / sum (0 past l), rowsum(dP P), 0)
  float4* st = reinterpret_cast<float4*>(stage + kBWarpgroups * kBTile);  // [lp]
  uint64_t* bar = reinterpret_cast<uint64_t*>(st + lp);             // [2]: Q and K; V and g

  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // warp-uniform as the compiler sees it (a shuffle of lane 0's value), so
  // the wgmma do not lie on a divergent path
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int h = blockIdx.x % num_heads, b = blockIdx.x / num_heads;
  const int d = num_heads * kDh, ld = 3 * d;
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&bar[0], (uint32_t)(2 * lp * 128));
    for (int i = 0; i < n_t; ++i) {
      tma_rows(qs + i * kBTile, &tq, dims.q, i * kBq, h, b, &bar[0]);
      tma_rows(ks + i * kBTile, &tk, dims.k, i * kBq, h, b, &bar[0]);
    }
    mbar_expect_tx(&bar[1], (uint32_t)(2 * lp * 128));
    for (int i = 0; i < n_t; ++i) {
      tma_rows(vs + i * kBTile, &tv, dims.v, i * kBq, h, b, &bar[1]);
      tma_rows(gs + i * kBTile, &tg, dims.g, i * kBq, h, b, &bar[1]);
    }
  }
  __syncthreads();

  const float c2 = sm_scale * kLog2e;
  const int rl = warp * 16 + g;               // this thread's first row of a tile
  bf16* out = dqkv + (size_t)b * l * ld + h * kDh;
  unsigned char* my_stage = stage + wg * kBTile;

  // a 64 x 64 fp32 tile rounded to bf16, staged swizzled, then written in
  // 16-byte stores to rows row0 + r < l of ``dst`` (row pitch ld)
  auto store_tile = [&](const float (&o)[32], bf16* dst, int row0) {
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j) {
      *reinterpret_cast<uint32_t*>(my_stage + sw128_offset(rl, j) + 4 * t) = pack_bf16(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(my_stage + sw128_offset(rl + 8, j) + 4 * t) =
          pack_bf16(o[4 * j + 2], o[4 * j + 3]);
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");  // this warpgroup only
    for (int k = tid & 127; k < kBq * 8; k += 128) {
      const int r = k >> 3, c = k & 7;
      if (row0 + r < l)
        *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * ld + c * 8) =
            *reinterpret_cast<const uint4*>(my_stage + sw128_offset(r, c));
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  };

  // ---- 1. the rows ----
  mbar_wait(&bar[0], 0);  // Q and K landed
  for (int qt = wg; qt < n_t; qt += kBWarpgroups) {
    const unsigned char* qtile = qs + qt * kBTile;
    const unsigned char* gtile = gs + qt * kBTile;
    // S of the NKC chunks at once, the whole row of valid keys in registers
    float s[NKC][32], dp[32], dq[32];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NKC; ++c) bwd_dot(s[c], qtile, ks + c * kBTile);
    wgmma_commit();
    wgmma_wait<0>();
    // the exact row max of the raw scores (scale > 0), keys >= kv_len at
    // kNegInf; p = exp(s scale - max) / sum in fp32, 0 at masked keys
    float m0 = kNegInf, m1 = kNegInf;
#pragma unroll
    for (int c = 0; c < NKC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = c * kBq + (i >> 2) * 8 + 2 * t + (i & 1);
        if (col >= kv_len) s[c][i] = kNegInf;
        if (i & 2) m1 = fmaxf(m1, s[c][i]); else m0 = fmaxf(m0, s[c][i]);
      }
    quad_max(m0, m1);
    const float mc0 = m0 * c2, mc1 = m1 * c2;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int c = 0; c < NKC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[c][i] = fast_exp2(fmaf(s[c][i], c2, (i & 2) ? -mc1 : -mc0));
        if (i & 2) l1 += s[c][i]; else l0 += s[c][i];
      }
    quad_sum(l0, l1);
    const float il0 = 1.f / l0, il1 = 1.f / l1;
#pragma unroll
    for (int c = 0; c < NKC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) s[c][i] *= (i & 2) ? il1 : il0;

    // D = rowsum(dP P), dP = g V^T chunk by chunk
    mbar_wait(&bar[1], 0);  // V and g landed
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int c = 0; c < NKC; ++c) {
      wgmma_fence();
      bwd_dot(dp, gtile, vs + c * kBTile);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2) d1 += s[c][i] * dp[i]; else d0 += s[c][i] * dp[i];
      }
    }
    quad_sum(d0, d1);
    const int r0 = qt * kBq + rl, r1 = r0 + 8;
    if (t == 0) {
      st[r0] = make_float4(mc0, r0 < l ? il0 : 0.f, d0, 0.f);
      st[r1] = make_float4(mc1, r1 < l ? il1 : 0.f, d1, 0.f);
    }

    // dS = P (dP - D) sm_scale rounded to bf16, dQ += dS K; dP recomputed,
    // the next chunk's issued with this chunk's dQ product
    uint32_t da[4][4];
    wgmma_fence();
    bwd_dot(dp, gtile, vs);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NKC; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[c][i] * (dp[i] - ((i & 2) ? d1 : d0)) * sm_scale;
      bwd_pack(da, dp);
      wgmma_fence();
      bwd_mul(dq, da, ks + c * kBTile, c == 0);
      if (c + 1 < NKC) bwd_dot(dp, gtile, vs + (c + 1) * kBTile);
      wgmma_commit();
      wgmma_wait<0>();
    }
    store_tile(dq, out, qt * kBq);
  }
  __syncthreads();  // every row's statistics are in shared memory
  mbar_wait(&bar[1], 0);  // V and g landed (a warpgroup with no query tile has not waited)

  // ---- 2. the keys ----
  for (int sl = wg; sl < n_t; sl += kBWarpgroups) {
    const int k0 = sl * kBq;
    float dk[32], dv[32];
    if (k0 < kv_len) {
      const unsigned char* kslice = ks + sl * kBTile;
      const unsigned char* vslice = vs + sl * kBTile;
      const bool ok0 = k0 + rl < kv_len, ok1 = k0 + rl + 8 < kv_len;
      float s[32], dp[32];
      uint32_t pa[4][4], da[4][4];
      // P^T and dS^T of query tile qt from S^T (s) and dP^T (dp)
      auto grads = [&](int qt) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 q = st[qt * kBq + 8 * j + 2 * t + e];  // (max x c2, 1 / sum, D, 0)
            const float p0 = ok0 ? fast_exp2(fmaf(s[4 * j + e], c2, -q.x)) * q.y : 0.f;
            const float p1 = ok1 ? fast_exp2(fmaf(s[4 * j + 2 + e], c2, -q.x)) * q.y : 0.f;
            dp[4 * j + e] = p0 * (dp[4 * j + e] - q.z) * sm_scale;
            dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - q.z) * sm_scale;
            s[4 * j + e] = p0;
            s[4 * j + 2 + e] = p1;
          }
        bwd_pack(pa, s);
        bwd_pack(da, dp);
      };
      wgmma_fence();
      bwd_dot(s, kslice, qs);
      bwd_dot(dp, vslice, gs);
      wgmma_commit();
      wgmma_wait<0>();
      for (int qt = 0; qt + 1 < n_t; ++qt) {
        grads(qt);
        wgmma_fence();
        bwd_mul(dv, pa, gs + qt * kBTile, qt == 0);
        bwd_mul(dk, da, qs + qt * kBTile, qt == 0);
        bwd_dot(s, kslice, qs + (qt + 1) * kBTile);
        bwd_dot(dp, vslice, gs + (qt + 1) * kBTile);
        wgmma_commit();
        wgmma_wait<0>();
      }
      grads(n_t - 1);
      wgmma_fence();
      bwd_mul(dv, pa, gs + (n_t - 1) * kBTile, n_t == 1);
      bwd_mul(dk, da, qs + (n_t - 1) * kBTile, n_t == 1);
      wgmma_commit();
      wgmma_wait<0>();
    } else {  // every key of the slice is masked: dK = dV = 0
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    }
    store_tile(dk, out + d, k0);
    store_tile(dv, out + 2 * d, k0);
  }
}

cudaError_t launch_attn_bwd_bf16(const void* qkv, const void* g, void* dqkv, int batch, int l,
                                 int num_heads, int kv_len, float sm_scale, cudaStream_t st) {
  const long long d = (long long)num_heads * kDh, three = 3 * d;
  const bf16* base = static_cast<const bf16*>(qkv);
  const long long qkv_st[3] = {l * three, kDh, three}, g_st[3] = {l * d, kDh, d};
  CUtensorMap tq, tk, tv, tg;
  BwdDims dims;
  cudaError_t e = encode_rows_map(&tq, dims.q, base, l, num_heads, batch, qkv_st, kBq);
  if (e == cudaSuccess) e = encode_rows_map(&tk, dims.k, base + d, l, num_heads, batch, qkv_st, kBq);
  if (e == cudaSuccess) e = encode_rows_map(&tv, dims.v, base + 2 * d, l, num_heads, batch, qkv_st, kBq);
  if (e == cudaSuccess) e = encode_rows_map(&tg, dims.g, g, l, num_heads, batch, g_st, kBq);
  if (e != cudaSuccess) return e;
  const size_t smem = bwd_smem_bytes((l + kBq - 1) / kBq * kBq);
  auto run = [&](auto kernel) {
    cudaError_t r = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (r != cudaSuccess) return r;
    kernel<<<batch * num_heads, kBThreads, smem, st>>>(static_cast<bf16*>(dqkv), l, num_heads, kv_len,
                                                      sm_scale, tq, tk, tv, tg, dims);
    return cudaGetLastError();
  };
  switch ((kv_len + kBq - 1) / kBq) {  // the key chunks holding a valid key
    case 1: return run(attn_bwd_bf16_kernel<1>);
    case 2: return run(attn_bwd_bf16_kernel<2>);
    case 3: return run(attn_bwd_bf16_kernel<3>);
    case 4: return run(attn_bwd_bf16_kernel<4>);
    case 5: return run(attn_bwd_bf16_kernel<5>);
    default: return cudaErrorInvalidValue;
  }
}

// ---- fp32: register-blocked SIMT ---------------------------------------------

constexpr int kFThreads = 256;            // 8 warps
constexpr int kFRowsW = 8;                // rows (queries in dQ, keys in dK/dV) a warp owns
constexpr int kFTile = 8 * kFRowsW;       // rows of a block
constexpr int kFChunk = 128;              // queries of one dK/dV step: 4 a lane
constexpr int kFPitch = kDh + 4;          // 68: a quarter warp's float4s on 8 rows hit distinct banks

size_t dq_f32_smem(int lp) { return (size_t)(2 * kFTile + 2 * lp) * kFPitch * sizeof(float); }
size_t dkv_f32_smem() {
  return ((size_t)(4 * kFChunk + 2 * kFTile) * kFPitch + 3 * kMaxL) * sizeof(float);
}

// rows [0, n) of a (rows, 64) fp32 slice with row pitch ``pitch`` into
// shared memory at pitch kFPitch, rows [n, total) zero (cp.async, uncommitted)
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int n, int total, size_t pitch) {
  for (int i = threadIdx.x; i < total * (kDh / 4); i += kFThreads) {
    const int r = i >> 4, c = (i & 15) * 4;
    cp_async16(dst + r * kFPitch + c, src + (size_t)(r < n ? r : 0) * pitch + c, r < n);
  }
}

// acc[i][j] = row i of ``rows`` (kFRowsW rows, the same for the whole warp:
// broadcast) . row lane + 32 j of ``cols``, over the head dim in order. Each
// float4 read of ``cols`` feeds 4 kFRowsW FMAs.
template <int NJ>
__device__ __forceinline__ void rows_dot_cols(float (&acc)[kFRowsW][NJ], const float* rows,
                                              const float* cols, int lane) {
#pragma unroll
  for (int i = 0; i < kFRowsW; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int dd = 0; dd < kDh; dd += 4) {
    float4 a[kFRowsW];
#pragma unroll
    for (int i = 0; i < kFRowsW; ++i) a[i] = *reinterpret_cast<const float4*>(rows + i * kFPitch + dd);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 c = *reinterpret_cast<const float4*>(cols + (lane + 32 * j) * kFPitch + dd);
#pragma unroll
      for (int i = 0; i < kFRowsW; ++i) {
        acc[i][j] = fmaf(a[i].x, c.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, c.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, c.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, c.w, acc[i][j]);
      }
    }
  }
}

// acc[e][c] += a[e] * v[c], four rows by four columns
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a, const float4 v) {
  const float av[4] = {a.x, a.y, a.z, a.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[e][c] = fmaf(av[e], vv[c], acc[e][c]);
}

// Writes the warp's kFRowsW x (32 NJ) register tile transposed: xt[lane +
// 32 j][8 warp + i] = x[i][j] (pitch kFPitch).
template <int NJ>
__device__ __forceinline__ void store_transposed(float* xt, const float (&x)[kFRowsW][NJ], int warp,
                                                 int lane) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float* p = xt + (lane + 32 * j) * kFPitch + kFRowsW * warp;
    *reinterpret_cast<float4*>(p) = make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(x[4][j], x[5][j], x[6][j], x[7][j]);
  }
}

// dQ and each query row's (max, sum, D): one block per (64-query tile, head,
// window), NJ = keys padded to a multiple of 64, / 32.
template <int NJ>
__global__ void __launch_bounds__(kFThreads, 1)
attn_bwd_dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ gout,
                       float* __restrict__ dqkv, float* __restrict__ stats, int l,
                       int num_heads, int kv_len, float sm_scale) {
  constexpr int LP = NJ * 32;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                    // [kFTile][kFPitch]
  float* gs = qs + kFTile * kFPitch;  // [kFTile][kFPitch]
  float* ks = gs + kFTile * kFPitch;  // [LP][kFPitch]
  float* vs = ks + LP * kFPitch;      // [LP][kFPitch], then dS^T
  const int q0 = blockIdx.x * kFTile, h = blockIdx.y, b = blockIdx.z;
  const int d = num_heads * kDh, three_d = 3 * d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* base = qkv + (size_t)b * l * three_d + h * kDh;
  const float* gbase = gout + (size_t)b * l * d + h * kDh;
  stage_f32(qs, base + (size_t)q0 * three_d, l - q0, kFTile, three_d);
  stage_f32(gs, gbase + (size_t)q0 * d, l - q0, kFTile, d);
  stage_f32(ks, base + d, l, LP, three_d);
  stage_f32(vs, base + 2 * d, l, LP, three_d);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // S and dP of the warp's rows: row i, key lane + 32 j
  const int r0 = q0 + kFRowsW * warp;
  float p[kFRowsW][NJ], ds[kFRowsW][NJ];
  if (r0 < l) {
    rows_dot_cols<NJ>(p, qs + kFRowsW * warp * kFPitch, ks, lane);
    rows_dot_cols<NJ>(ds, gs + kFRowsW * warp * kFPitch, vs, lane);
#pragma unroll
    for (int i = 0; i < kFRowsW; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        p[i][j] = lane + 32 * j < kv_len ? p[i][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, p[i][j]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        p[i][j] = expf(p[i][j] - mx);
        sum += p[i][j];
      }
      sum = warp_sum(sum);
      float dsum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        p[i][j] = p[i][j] / sum;
        dsum += ds[i][j] * p[i][j];
      }
      dsum = warp_sum(dsum);
#pragma unroll
      for (int j = 0; j < NJ; ++j) ds[i][j] = p[i][j] * (ds[i][j] - dsum) * sm_scale;
      if (lane == 0 && r0 + i < l) {
        float* st = stats + (size_t)(b * num_heads + h) * 3 * l + r0 + i;
        st[0] = mx;
        st[l] = sum;
        st[2 * l] = dsum;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kFRowsW; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) ds[i][j] = 0.f;
  }
  __syncthreads();  // V is read: dS^T takes its place
  store_transposed<NJ>(vs, ds, warp, lane);
  __syncthreads();

  // dQ = dS K over the unmasked keys (dS is exactly 0 at the others):
  // thread rows 4 ty .. + 3, columns 4 tx .. + 3
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4] = {};
  const int nk = min(l, kv_len);
#pragma unroll 4
  for (int k = 0; k < nk; ++k)
    outer4(acc, *reinterpret_cast<const float4*>(vs + k * kFPitch + 4 * ty),
           *reinterpret_cast<const float4*>(ks + k * kFPitch + 4 * tx));
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = q0 + 4 * ty + e;
    if (r < l)
      *reinterpret_cast<float4*>(dqkv + ((size_t)b * l + r) * three_d + h * kDh + 4 * tx) =
          make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
  }
}

// dK and dV: one block per (64-key tile, head, window), the queries swept in
// chunks of 128 (a lane's 4), P^T and dS^T from the row statistics.
__global__ void __launch_bounds__(kFThreads, 1)
attn_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ gout,
                        float* __restrict__ dqkv, const float* __restrict__ stats, int l,
                        int num_heads, int kv_len, float sm_scale) {
  constexpr int NJ = kFChunk / 32;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                      // [kFChunk][kFPitch]
  float* gs = qs + kFChunk * kFPitch;   // [kFChunk][kFPitch]
  float* xp = gs + kFChunk * kFPitch;   // [kFChunk][kFPitch]: P^T
  float* xd = xp + kFChunk * kFPitch;   // [kFChunk][kFPitch]: dS^T
  float* kt = xd + kFChunk * kFPitch;   // [kFTile][kFPitch]
  float* vt = kt + kFTile * kFPitch;    // [kFTile][kFPitch]
  float* mx_s = vt + kFTile * kFPitch;  // [3][kMaxL]: max, sum, D of each query
  const int k0 = blockIdx.x * kFTile, h = blockIdx.y, b = blockIdx.z;
  const int d = num_heads * kDh, three_d = 3 * d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = tid >> 4, tx = tid & 15;
  const float* base = qkv + (size_t)b * l * three_d + h * kDh;
  const float* gbase = gout + (size_t)b * l * d + h * kDh;
  stage_f32(kt, base + (size_t)k0 * three_d + d, l - k0, kFTile, three_d);
  stage_f32(vt, base + (size_t)k0 * three_d + 2 * d, l - k0, kFTile, three_d);
  const float* st = stats + (size_t)(b * num_heads + h) * 3 * l;
  for (int r = tid; r < l; r += kFThreads) {
    mx_s[r] = st[r];
    mx_s[kMaxL + r] = st[l + r];
    mx_s[2 * kMaxL + r] = st[2 * l + r];
  }

  const int key0 = k0 + kFRowsW * warp;
  const bool active = key0 < min(l, kv_len);  // else every key of the warp is masked: P = 0
  float dk[4][4] = {}, dv[4][4] = {};
  for (int c0 = 0; c0 < l; c0 += kFChunk) {
    const int nq = min(kFChunk, l - c0);
    __syncthreads();  // the last chunk's tiles are read
    stage_f32(qs, base + (size_t)c0 * three_d, nq, kFChunk, three_d);
    stage_f32(gs, gbase + (size_t)c0 * d, nq, kFChunk, d);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float p[kFRowsW][NJ], ds[kFRowsW][NJ];
    if (active) {
      // S^T and dP^T: key row i, query c0 + lane + 32 j
      rows_dot_cols<NJ>(p, kt + kFRowsW * warp * kFPitch, qs, lane);
      rows_dot_cols<NJ>(ds, vt + kFRowsW * warp * kFPitch, gs, lane);
#pragma unroll
      for (int i = 0; i < kFRowsW; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int q = c0 + lane + 32 * j;
          const bool ok = key0 + i < kv_len && q < l;
          const int qi = ok ? q : 0;  // the statistics hold the l real queries only
          p[i][j] = ok ? expf(p[i][j] * sm_scale - mx_s[qi]) / mx_s[kMaxL + qi] : 0.f;
          ds[i][j] = ok ? p[i][j] * (ds[i][j] - mx_s[2 * kMaxL + qi]) * sm_scale : 0.f;
        }
    } else {
#pragma unroll
      for (int i = 0; i < kFRowsW; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) p[i][j] = ds[i][j] = 0.f;
    }
    store_transposed<NJ>(xp, p, warp, lane);
    store_transposed<NJ>(xd, ds, warp, lane);
    __syncthreads();
    // dV += P^T g, dK += dS^T Q: thread keys 4 ty .. + 3, columns 4 tx .. + 3
#pragma unroll 2
    for (int r = 0; r < nq; ++r) {
      outer4(dv, *reinterpret_cast<const float4*>(xp + r * kFPitch + 4 * ty),
             *reinterpret_cast<const float4*>(gs + r * kFPitch + 4 * tx));
      outer4(dk, *reinterpret_cast<const float4*>(xd + r * kFPitch + 4 * ty),
             *reinterpret_cast<const float4*>(qs + r * kFPitch + 4 * tx));
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = k0 + 4 * ty + e;
    if (r < l) {
      float* krow = dqkv + ((size_t)b * l + r) * three_d + d + h * kDh + 4 * tx;
      *reinterpret_cast<float4*>(krow) = make_float4(dk[e][0], dk[e][1], dk[e][2], dk[e][3]);
      *reinterpret_cast<float4*>(krow + d) = make_float4(dv[e][0], dv[e][1], dv[e][2], dv[e][3]);
    }
  }
}

template <int NJ>
cudaError_t launch_dq_f32(const float* qkv, const float* g, float* dqkv, float* stats, int batch,
                          int l, int num_heads, int kv_len, float sm_scale, cudaStream_t st) {
  const size_t smem = dq_f32_smem(NJ * 32);
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_dq_f32_kernel<NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((l + kFTile - 1) / kFTile, num_heads, batch);
  attn_bwd_dq_f32_kernel<NJ><<<grid, kFThreads, smem, st>>>(qkv, g, dqkv, stats, l, num_heads,
                                                            kv_len, sm_scale);
  return cudaGetLastError();
}

// ---- bf16: dy = d_qkv . W and the frozen LayerNorm's backward ---------------

constexpr int kYM = 32;        // rows of a block
constexpr int kYK = 32;        // depth of one stage
constexpr int kYStages = 3;
constexpr int kYWarps = 8;     // warp w owns columns [w D/8, (w+1) D/8)
constexpr int kYMaxNT = 12;    // n-tiles of 8 a warp holds at D = 768
constexpr int kYMaxDim = kYWarps * kYMaxNT * 8;
constexpr int kYAPitch = kYK + 8;  // 80 B: ldmatrix rows on distinct banks
constexpr int kLnVecs = kYMaxDim / 256;  // 8-wide chunks a lane holds for the statistics

size_t ydx_smem(int d) {
  return (size_t)kYStages * (kYM * kYAPitch + kYK * (d + 8)) * sizeof(bf16);
}

__global__ void __launch_bounds__(kYWarps * 32, 1)
ln_bwd_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dqkv,
                 const float* __restrict__ gamma, const bf16* __restrict__ w,
                 bf16* __restrict__ dx, int m, int d, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float mu_s[kYM], rstd_s[kYM], red1[kYWarps][kYM], red2[kYWarps][kYM];
  const int bpitch = d + 8;
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + (size_t)kYStages * kYM * kYAPitch;
  const int n3 = 3 * d;
  const int row0 = blockIdx.x * kYM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nsteps = n3 / kYK;

  auto load = [&](int kt) {
    const int st = kt % kYStages, k0 = kt * kYK;
    bf16* a = as + (size_t)st * kYM * kYAPitch;
    bf16* bt = bs + (size_t)st * kYK * bpitch;
    for (int i = tid; i < kYM * (kYK / 8); i += kYWarps * 32) {
      const int r = i / (kYK / 8), c = i % (kYK / 8);
      const bool ok = row0 + r < m;
      cp_async16(a + r * kYAPitch + c * 8, dqkv + (size_t)(ok ? row0 + r : 0) * n3 + k0 + c * 8, ok);
    }
    const int cpr = d / 8;
    for (int i = tid; i < kYK * cpr; i += kYWarps * 32) {
      const int r = i / cpr, c = i - r * cpr;
      cp_async16(bt + (size_t)r * bpitch + c * 8, w + (size_t)(k0 + r) * d + c * 8, true);
    }
  };
#pragma unroll
  for (int s = 0; s < kYStages - 1; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }

  // LayerNorm statistics of the block's rows (fp32, two passes over
  // registers, a warp a row) while the first tiles land
  const int xvec = d / 8;
  for (int r = warp; r < kYM; r += kYWarps) {
    const int gr = row0 + r;
    float v[kLnVecs][8];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kLnVecs; ++c) {
      const int cc = c * 32 + lane;
      if (gr < m && cc < xvec) {
        const uint4 u = *reinterpret_cast<const uint4*>(x + (size_t)gr * d + cc * 8);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h2[e]);
          v[c][2 * e] = f.x;
          v[c][2 * e + 1] = f.y;
          sum += f.x + f.y;
        }
      }
    }
    const float mu = warp_sum(sum) / d;
    float var = 0.f;
#pragma unroll
    for (int c = 0; c < kLnVecs; ++c)
      if (gr < m && c * 32 + lane < xvec)
#pragma unroll
        for (int e = 0; e < 8; ++e) var += (v[c][e] - mu) * (v[c][e] - mu);
    const float rstd = rsqrtf(warp_sum(var) / d + eps);
    if (lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
    }
  }

  // dy[32 x D] = d_qkv[rows, :] . W: warp w takes columns c0 .. c0 + 8 nt
  const int nt_count = d / (kYWarps * 8);
  const int c0 = warp * nt_count * 8;
  float acc[2][kYMaxNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kYMaxNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int kt = 0; kt < nsteps; ++kt) {
    cp_async_wait<kYStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is read by everyone
    if (kt + kYStages - 1 < nsteps) load(kt + kYStages - 1);
    cp_async_commit();
    const bf16* a = as + (size_t)(kt % kYStages) * kYM * kYAPitch;
    const bf16* bt = bs + (size_t)(kt % kYStages) * kYK * bpitch;
#pragma unroll
    for (int kk = 0; kk < kYK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(af[mt], a + (mt * 16 + (lane & 15)) * kYAPitch + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kYMaxNT / 2; ++np) {
        if (2 * np < nt_count) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, bt + (size_t)(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * bpitch +
                                     c0 + np * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], af[mt], bfr[0], bfr[1]);
            mma_bf16(acc[mt][2 * np + 1], af[mt], bfr[2], bfr[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // LayerNorm backward with frozen parameters: dyh = dy gamma,
  // dx = rstd (dyh - mean(dyh) - xhat mean(dyh xhat))
  float s1[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, s2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rl = mt * 16 + g + 8 * hr, gr = row0 + rl;
      if (gr >= m) continue;
      const float mu = mu_s[rl], rstd = rstd_s[rl];
#pragma unroll
      for (int nt = 0; nt < kYMaxNT; ++nt) {
        if (nt < nt_count) {
          const int col = c0 + nt * 8 + 2 * t;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)gr * d + col));
          const float xh0 = (xv.x - mu) * rstd, xh1 = (xv.y - mu) * rstd;
          const float d0 = acc[mt][nt][2 * hr] * gamma[col];
          const float d1 = acc[mt][nt][2 * hr + 1] * gamma[col + 1];
          acc[mt][nt][2 * hr] = d0;
          acc[mt][nt][2 * hr + 1] = d1;
          s1[mt][hr] += d0 + d1;
          s2[mt][hr] += d0 * xh0 + d1 * xh1;
        }
      }
    }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        s1[mt][hr] += __shfl_xor_sync(0xffffffffu, s1[mt][hr], o);
        s2[mt][hr] += __shfl_xor_sync(0xffffffffu, s2[mt][hr], o);
      }
      if (t == 0) {
        red1[warp][mt * 16 + g + 8 * hr] = s1[mt][hr];
        red2[warp][mt * 16 + g + 8 * hr] = s2[mt][hr];
      }
    }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int rl = mt * 16 + g + 8 * hr, gr = row0 + rl;
      if (gr >= m) continue;
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int ww = 0; ww < kYWarps; ++ww) {
        m1 += red1[ww][rl];
        m2 += red2[ww][rl];
      }
      m1 /= d;
      m2 /= d;
      const float mu = mu_s[rl], rstd = rstd_s[rl];
#pragma unroll
      for (int nt = 0; nt < kYMaxNT; ++nt) {
        if (nt < nt_count) {
          const int col = c0 + nt * 8 + 2 * t;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)gr * d + col));
          const float xh0 = (xv.x - mu) * rstd, xh1 = (xv.y - mu) * rstd;
          *reinterpret_cast<uint32_t*>(dx + (size_t)gr * d + col) =
              pack_bf16(rstd * (acc[mt][nt][2 * hr] - m1 - xh0 * m2),
                        rstd * (acc[mt][nt][2 * hr + 1] - m1 - xh1 * m2));
        }
      }
    }
}

bool attn_shapes_ok(int l, int d, int num_heads, int kv_len) {
  return d == num_heads * kDh && l >= 1 && l <= kMaxL && kv_len >= 1 && kv_len <= l;
}

}  // namespace
}  // namespace ebc

// qkv (B, L, 3D) bf16; g (B, L, D) bf16; dqkv (B, L, 3D) bf16 out; stats
// unused (the fp32 entry's scratch). Returns the CUDA error code (0 = ok).
extern "C" int ebc_attention_bwd(const void* qkv, const void* g, void* dqkv, void* stats,
                                 int batch, int l, int d, int num_heads, int kv_len,
                                 float sm_scale, void* stream) {
  using namespace ebc;
  (void)stats;
  if (!attn_shapes_ok(l, d, num_heads, kv_len) || batch < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_attn_bwd_bf16(qkv, g, dqkv, batch, l, num_heads, kv_len, sm_scale,
                                   static_cast<cudaStream_t>(stream));
}

// The same in fp32: qkv, g and dqkv fp32, with ebc_attention_bwd's shapes;
// stats (B, H, 3, L) fp32 scratch.
extern "C" int ebc_attention_bwd_f32(const void* qkv, const void* g, void* dqkv, void* stats,
                                     int batch, int l, int d, int num_heads, int kv_len,
                                     float sm_scale, void* stream) {
  using namespace ebc;
  if (!attn_shapes_ok(l, d, num_heads, kv_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qkv);
  const float* go = static_cast<const float*>(g);
  float* dq = static_cast<float*>(dqkv);
  float* sts = static_cast<float*>(stats);
  cudaError_t e;
  switch ((l + 63) / 64) {  // keys padded to a multiple of 64 pick the instantiation
    case 1: e = launch_dq_f32<2>(q, go, dq, sts, batch, l, num_heads, kv_len, sm_scale, st); break;
    case 2: e = launch_dq_f32<4>(q, go, dq, sts, batch, l, num_heads, kv_len, sm_scale, st); break;
    case 3: e = launch_dq_f32<6>(q, go, dq, sts, batch, l, num_heads, kv_len, sm_scale, st); break;
    case 4: e = launch_dq_f32<8>(q, go, dq, sts, batch, l, num_heads, kv_len, sm_scale, st); break;
    default: e = launch_dq_f32<10>(q, go, dq, sts, batch, l, num_heads, kv_len, sm_scale, st); break;
  }
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(attn_bwd_dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dkv_f32_smem());
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dkv_f32_kernel<<<dim3((l + kFTile - 1) / kFTile, num_heads, batch), kFThreads,
                            dkv_f32_smem(), st>>>(q, go, dq, sts, l, num_heads, kv_len, sm_scale);
  return (int)cudaGetLastError();
}

// x (M, D) bf16 (the block input), dqkv (M, 3D) bf16, gamma (D,) fp32, w
// (3D, D) bf16 in torch Linear (out, in) layout -> dx (M, D) bf16.
extern "C" int ebc_ln_bwd_dx(const void* x, const void* dqkv, const void* gamma, const void* w,
                             void* dx, int m, int d, float eps, void* stream) {
  using namespace ebc;
  if (m < 1 || d < 128 || d % 128 || d > kYMaxDim) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = ydx_smem(d);
  cudaError_t e = cudaFuncSetAttribute(ln_bwd_dx_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ln_bwd_dx_kernel<<<(m + kYM - 1) / kYM, kYWarps * 32, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dqkv),
      static_cast<const float*>(gamma), static_cast<const bf16*>(w), static_cast<bf16*>(dx), m,
      d, eps);
  return (int)cudaGetLastError();
}
