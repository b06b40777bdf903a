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
// do. dy = d_qkv . W is M = 3664 x K = 2304 x N = 768 (13.0 GFLOP, 0.0131
// ms, against 31.7 MB of d_qkv, W, x and dx, 0.0095 ms: operations bound
// ebc_ln_bwd_dx); with the recomputed projection and the attention the
// frozen backward is 32.4 GFLOP, 0.033 ms at 989 TFLOP/s.
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
//  * ln_bwd_dx_kernel (wgmma, TMA, clusters, sm_90a; redesigned after the
//    first port, a block of 8 mma.sync warps per 32 rows x all D columns
//    with W streamed whole through a cp.async ring by each of its 115
//    blocks: 0.117 ms at the flagship step on an H100 SXM at 700 W, where
//    a copy that loaded W's tiles once took 0.059 and one without any mma
//    0.114, so W's 407 MB of L2 reads led). A cluster of D / 192 blocks
//    (4 at D = 768) owns a 128-row tile, each block 192 of its columns, so
//    W's L2 reads fall to 103 MB and 116 blocks fill 132 SMs: two consumer
//    warpgroups of 64 rows x 192 columns on wgmma m64n192k16 (W MN-major
//    as torch's (out, in) layout stands), d_qkv and W by TMA through a
//    4-stage ring; a third warpgroup takes the LN statistics (once a row
//    in the cluster, written to every block through distributed shared
//    memory) under the products (in the prologue they cost 0.0029 ms);
//    the LayerNorm backward's two row sums over the block's columns go to
//    every block the same way, and dx is staged in the x tile's place and
//    stored by TMA. Only dx is written. At ViT-L's D = 1024 (M = 16 x 289
//    at a training step: 29.1 GFLOP, 0.029 ms at 989 TFLOP/s, against 54
//    MB, 0.016 ms) the 16 boxes of 64 columns do not split into three: a
//    cluster of 8 blocks of 128 columns (wgmma m64n128k16), the portable
//    cluster maximum, 174 KB of shared memory a block; the statistics
//    warpgroup holds a row as 4 chunks of 8 a lane, 3 rows a warp at a time.
//  * Costs to remove later: qkv and d_qkv each make a round trip through
//    device memory (16.9 MB each per layer at the flagship shape), which
//    the Pallas kernel kept in VMEM.
//
// Limits: head dim 64; L <= 320; the LN backward needs D % 128 == 0 and D
// <= 1024 (the statistics hold a row in registers, 4 x 8 values a lane past
// D = 768; a row tile's cluster is D / 128 blocks past D = 768, 8 at D =
// 1024, the portable maximum; the ring and the x tile fill shared memory).

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

constexpr int kXM = 128;           // rows of a block: two consumer warpgroups x 64
constexpr int kXK = 64;            // depth of a ring step: one 128-byte swizzle row of d_qkv
constexpr int kXStages = 4;        // ring steps in flight
constexpr int kXWarps = 8;         // two consumer warpgroups; the last warp done with a step refills it
constexpr int kXThreads = kXWarps * 32 + 128;  // and a warpgroup for the LN statistics
constexpr int kXMaxDim = 1024;     // the statistics pass holds a row in registers (XC x 8 values a lane)
constexpr int kXATile = kXM * 128;  // bytes of a 128-row tile 64 values deep (d_qkv step, x or dx box)
constexpr int kXWBox = kXK * 128;   // bytes of a W box: 64 rows (the depth) x 64 columns

__host__ __device__ constexpr int dx_stage_bytes(int nc) { return kXATile + nc * kXWBox; }
// Blocks of a row tile, D / 64 / NC, at most: 5 for the instantiations of
// D <= 768 (D = 640: 5 of 128 columns), 8 (the portable cluster maximum)
// for those of D = 896 and 1024 (8 of 128 columns at D = 1024)
__host__ __device__ constexpr int dx_max_cluster(int xc) { return xc > 3 ? 8 : 5; }
// the ring, the x tile (dx staged in its place), each row's (mu, rstd), the
// cluster's partial row sums, the barriers and done counts, 1024-byte alignment
__host__ __device__ constexpr size_t dx_smem_bytes(int nc, int xc) {
  return (size_t)kXStages * dx_stage_bytes(nc) + (size_t)nc * kXATile + kXM * sizeof(float2) +
         (size_t)dx_max_cluster(xc) * kXM * sizeof(float2) + (kXStages + 1) * 8 + kXStages * 4 + 1024;
}

// Shared-memory descriptor of an MN-major bf16 B operand in the 128-byte
// swizzle layout (16 rows of the depth a k-step, each row 64 columns = 128 B,
// 8-row atoms 1024 B apart), its 64-column atoms ``lbo`` bytes apart.
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 fp32, 64 a thread) (+)= A (64 x 16 bf16, K-major) . B (16 x 128
// bf16, MN-major: 2 atoms of 64 columns, lbo bytes apart), both in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_ss_tb(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 192 fp32, 96 a thread) (+)= A (64 x 16 bf16, K-major) . B (16 x 192
// bf16, MN-major: 3 atoms of 64 columns, lbo bytes apart), both in shared memory.
__device__ __forceinline__ void wgmma_m64n192k16_ss_tb(float (&d)[96], uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 NC) (+)= A (64 x 16, K-major) . B (16 x 64 NC, NC MN-major atoms
// kXWBox apart), both in shared memory.
template <int NC>
__device__ __forceinline__ void dx_mma(float (&d)[32 * NC], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  if constexpr (NC == 3)
    wgmma_m64n192k16_ss_tb(d, desc_a, desc_b, accumulate);
  else
    wgmma_m64n128k16_ss_tb(d, desc_a, desc_b, accumulate);
}

// A cluster of CN = D / 64 NC blocks owns a 128-row tile (blockIdx.x /
// CN); its block of rank r the columns [64 NC r, 64 NC (r + 1)). Consumer
// warpgroup wg takes rows 64 wg .. + 63 of the tile: dy (64 x 64 NC fp32)
// = d_qkv[rows, :] . W[:, columns] on wgmma, d_qkv's 128 rows and W's NC
// 64-column boxes 64 deep a ring step by TMA (128B-swizzled; W MN-major, as
// torch's (out, in) layout stands), the steps on per-stage mbarriers, the
// last of the 8 consumer warps done with a stage refilling it. Meanwhile
// the x tile of the block's columns lands by TMA, and a third warpgroup
// takes the LN statistics once a row in the cluster (block r rows r, r +
// CN, ..) and writes them to every block. Then dyh = dy gamma, the row sums of dyh
// and dyh xhat over the block's columns go to every block, and dx = rstd
// (dyh - m1 - xhat m2) is staged in the x tile's place and stored by TMA
// (rows past m clipped). XC = ceil(D / 256): the 8-value chunks a lane
// holds of a row in the statistics pass (3 up to D = 768, 4 past it).
template <int NC, int XC>
__global__ void __launch_bounds__(kXThreads, 1)
ln_bwd_dx_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                 const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdx, int m,
                 int d, float eps) {
  constexpr int kStage = dx_stage_bytes(NC);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = sm;                                            // [kXStages][d_qkv tile, NC W boxes]
  unsigned char* xs = ring + kXStages * kStage;                        // [NC][128 rows x 128 B]
  float2* stats = reinterpret_cast<float2*>(xs + NC * kXATile);        // [128]: mu, rstd
  float2* red = stats + kXM;                                           // [cluster rank][128]: the row sums
  uint64_t* full = reinterpret_cast<uint64_t*>(red + dx_max_cluster(XC) * kXM);  // [kXStages]
  uint64_t* xbar = full + kXStages;
  int* done = reinterpret_cast<int*>(xbar + 1);                        // [kXStages]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cn = d / (64 * NC), rank = blockIdx.x % cn;  // the cluster: the blocks of one row tile
  const int row0 = blockIdx.x / cn * kXM, col0 = rank * NC * 64;
  const int nsteps = 3 * d / kXK;

  // ring step s (depth 64 s ..) into its stage: the tile's d_qkv rows and
  // the block's W boxes, rows past m as zeros; one thread
  auto load = [&](int s) {
    if (s >= nsteps) return;
    const int st = s % kXStages;
    unsigned char* dst = ring + st * kStage;
    mbar_expect_tx(&full[st], (uint32_t)kStage);
    tma_2d(dst, &ta, s * kXK, row0, &full[st]);
#pragma unroll
    for (int c = 0; c < NC; ++c) tma_2d(dst + kXATile + c * kXWBox, &tw, col0 + c * 64, s * kXK, &full[st]);
  };
  if (tid == 0) {
    for (int st = 0; st < kXStages; ++st) {
      mbar_init(&full[st], 1);
      done[st] = 0;
    }
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(xbar, (uint32_t)(NC * kXATile));
#pragma unroll
    for (int c = 0; c < NC; ++c) tma_2d(xs + c * kXATile, &tx, col0 + c * 64, row0, xbar);
    for (int s = 0; s < kXStages; ++s) load(s);
  }
  __syncthreads();
  cluster_arrive();  // every block of the cluster runs before any writes to another's shared memory
  cluster_wait();
  // warp-uniform as the compiler sees it (a shuffle of lane 0's value), so
  // the wgmma do not lie on a divergent path: 0, 1 the consumer
  // warpgroups, 2 the statistics warpgroup
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  float acc[32 * NC];
  if (role == 2) {
    // 1. LN statistics (fp32, two passes over the row in registers, a warp
    //    a row, the first port's order of operations; rows past m are
    //    zeros) of rows rank, rank + cn, .. of the tile, a warp's rows 4 at
    //    a time (3 past D = 768, so that a warp still holds 96 values) with
    //    their loads issued together, to every block of the cluster, under
    //    the products
    constexpr int kStatRows = XC > 3 ? 3 : 4, kXC = XC;
    const int xvec = d / 8, sw = warp & 3;
    for (int i0 = sw * kStatRows; i0 * cn + rank < kXM; i0 += 4 * kStatRows) {
      float v[kStatRows][kXC][8];
#pragma unroll
      for (int b = 0; b < kStatRows; ++b) {
        const int r = (i0 + b) * cn + rank, gr = row0 + r;
#pragma unroll
        for (int c = 0; c < kXC; ++c) {
          const int cc = c * 32 + lane;
#pragma unroll
          for (int e = 0; e < 8; ++e) v[b][c][e] = 0.f;
          if (r < kXM && gr < m && cc < xvec) load8(x + (size_t)gr * d + cc * 8, v[b][c]);
        }
      }
#pragma unroll
      for (int b = 0; b < kStatRows; ++b) {
        const int r = (i0 + b) * cn + rank;
        if (r >= kXM) break;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < kXC; ++c)
#pragma unroll
          for (int e = 0; e < 8; ++e) sum += v[b][c][e];
        const float mu = warp_sum(sum) / d;
        float var = 0.f;
#pragma unroll
        for (int c = 0; c < kXC; ++c)
          if (c * 32 + lane < xvec)
#pragma unroll
            for (int e = 0; e < 8; ++e) var += (v[b][c][e] - mu) * (v[b][c][e] - mu);
        const float rstd = rsqrtf(warp_sum(var) / d + eps);
        if (lane < cn) st_cluster(&stats[r], make_float2(mu, rstd), lane);
      }
    }
    cluster_arrive();  // the statistics are out; waited on before the epilogue
  } else {
    cluster_arrive();
    // 2. dy = d_qkv . W: step s issued while step s - 1's products finish,
    //    then step s - 1's stage released (every barrier wait precedes the
    //    wgmma fence; the accumulators are read after the last wait)
    const unsigned char* rows = ring + role * 64 * 128;  // this warpgroup's 64 rows of a stage
    auto release = [&](int s) {  // this warp is done with step s; the last of the 8 refills the stage
      const int st = s % kXStages;
      if (lane == 0 && atomicAdd(&done[st], 1) == kXWarps - 1) {
        done[st] = 0;
        load(s + kXStages);
      }
    };
    for (int s = 0; s < nsteps; ++s) {
      const int st = s % kXStages;
      mbar_wait(&full[st], (s / kXStages) & 1);
      const unsigned char* a = rows + st * kStage;
      const unsigned char* wb = ring + st * kStage + kXATile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kXK / 16; ++kk)
        dx_mma<NC>(acc, sw128_desc(a + kk * 32), sw128_mn_desc(wb + kk * 16 * 128, kXWBox), s + kk > 0);
      wgmma_commit();
      if (s > 0) {
        wgmma_wait<1>();
        release(s - 1);
      }
    }
    wgmma_wait<0>();
    release(nsteps - 1);
  }

  // 3. the LayerNorm backward with frozen parameters: dyh = dy gamma; the
  //    block's share of each row's sums of dyh and dyh xhat to every block
  cluster_wait();  // the statistics
  const int g = lane >> 2, t4 = lane & 3;
  const int rl[2] = {role * 64 + (warp & 3) * 16 + g, role * 64 + (warp & 3) * 16 + g + 8};
  float2 st2[2] = {};
  if (role < 2) {
    mbar_wait(xbar, 0);
    st2[0] = stats[rl[0]];
    st2[1] = stats[rl[1]];
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8 * NC; ++j) {
      const float2 gm = *reinterpret_cast<const float2*>(gamma + col0 + j * 8 + 2 * t4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            xs + (j >> 3) * kXATile + sw128_offset(rl[h], j & 7) + 4 * t4));
        const float xh0 = (xv.x - st2[h].x) * st2[h].y, xh1 = (xv.y - st2[h].x) * st2[h].y;
        const float d0 = acc[4 * j + 2 * h] * gm.x, d1 = acc[4 * j + 2 * h + 1] * gm.y;
        acc[4 * j + 2 * h] = d0;
        acc[4 * j + 2 * h + 1] = d1;
        s1[h] += d0 + d1;
        s2[h] += d0 * xh0 + d1 * xh1;
      }
    }
    quad_sum(s1[0], s1[1]);
    quad_sum(s2[0], s2[1]);
    for (int c = t4; c < cn; c += 4) {
      st_cluster(&red[rank * kXM + rl[0]], make_float2(s1[0], s2[0]), c);
      st_cluster(&red[rank * kXM + rl[1]], make_float2(s1[1], s2[1]), c);
    }
  }
  cluster_arrive();
  cluster_wait();

  // 4. m1, m2 over the whole row (the blocks' sums in rank order, so every
  //    block has the same), dx rounded once to bf16 in the x tile's place
  if (role < 2) {
    float m1[2], m2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a1 = 0.f, a2 = 0.f;
      for (int c = 0; c < cn; ++c) {
        const float2 v = red[c * kXM + rl[h]];
        a1 += v.x;
        a2 += v.y;
      }
      m1[h] = a1 / d;
      m2[h] = a2 / d;
    }
#pragma unroll
    for (int j = 0; j < 8 * NC; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned char* p = xs + (j >> 3) * kXATile + sw128_offset(rl[h], j & 7) + 4 * t4;
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
        const float xh0 = (xv.x - st2[h].x) * st2[h].y, xh1 = (xv.y - st2[h].x) * st2[h].y;
        *reinterpret_cast<uint32_t*>(p) =
            pack_bf16(st2[h].y * (acc[4 * j + 2 * h] - m1[h] - xh0 * m2[h]),
                      st2[h].y * (acc[4 * j + 2 * h + 1] - m1[h] - xh1 * m2[h]));
      }
    }
  }
  fence_proxy_async();  // the staged dx, for the TMA store's async proxy
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) tma_store_2d(&tdx, xs + c * kXATile, col0 + c * 64, row0);
    bulk_commit();
    bulk_wait_all();
  }
}

template <int NC, int XC>
cudaError_t launch_ln_bwd_dx(const void* x, const void* dqkv, const void* gamma, const void* w, void* dx,
                             int m, int d, float eps, cudaStream_t st) {
  CUtensorMap ta, tw, tx, tdx;
  cudaError_t e = encode_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dqkv, 3 * d, m, kXM);
  if (e == cudaSuccess) e = encode_map(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, d, 3 * d, kXK);
  if (e == cudaSuccess) e = encode_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, d, m, kXM);
  if (e == cudaSuccess) e = encode_map(&tdx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dx, d, m, kXM);
  if (e != cudaSuccess) return e;
  const size_t smem = dx_smem_bytes(NC, XC);
  e = cudaFuncSetAttribute(ln_bwd_dx_kernel<NC, XC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int cn = d / (64 * NC);
  return launch_clustered(ln_bwd_dx_kernel<NC, XC>, cn * ((m + kXM - 1) / kXM), kXThreads, smem, cn, st,
                          static_cast<const bf16*>(x), static_cast<const float*>(gamma), ta, tw, tx, tdx, m, d,
                          eps);
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
  if (m < 1 || d < 128 || d % 128 || d > kXMaxDim) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 64-column boxes a block: 3 where they split D evenly, else 2 (D = 896
  // and 1024: clusters of 7 and 8 blocks, a row of 4 chunks a lane)
  if (d > 768) return (int)launch_ln_bwd_dx<2, 4>(x, dqkv, gamma, w, dx, m, d, eps, st);
  return (int)((d / 64) % 3 == 0 ? launch_ln_bwd_dx<3, 3>(x, dqkv, gamma, w, dx, m, d, eps, st)
                                 : launch_ln_bwd_dx<2, 3>(x, dqkv, gamma, w, dx, m, d, eps, st));
}
