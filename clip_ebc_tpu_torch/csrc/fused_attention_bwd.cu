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
// Design, right and simple first (making it fast is a later step):
//  * The softmax of a query row needs every key, and dK/dV of a key row
//    need every query, so the work splits in two launches that each own
//    one side: attn_bwd_dq_kernel, one block (4 warps, 16 query rows
//    each) per (64-query tile, head, window) with K_h and V_h of the
//    window in shared memory, sweeps the keys 16 at a time three times
//    (row max and sum, online; then D = rowsum(dP P); then dS and dQ),
//    recomputing S = Q K^T and dP = g V^T per chunk with mma.sync instead
//    of holding a score row in registers. It writes dQ and each row's
//    (max, sum, D) to a small fp32 scratch. attn_bwd_dkv_kernel, one block
//    per (64-key tile, head, window) with Q_h, g_h and the row statistics
//    in shared memory, sweeps the queries 16 at a time: S^T = K Q^T, P^T
//    from the statistics, dP^T = V g^T, then dK += dS^T Q and dV += P^T g
//    with the score tiles fed back from the accumulators as A operands.
//    What this costs: S is recomputed four times and dP twice (about 2x
//    the FLOP of a single-pass kernel), which at these sizes the card
//    hides; nothing of size L x L touches device memory.
//  * fp32 (training without --amp; redesigned after the first port, a warp
//    a row reading one shared-memory operand per FMA): the same split, in
//    register-blocked SIMT fp32 (the tensor cores take no fp32 short of
//    TF32, which would round where the plain version does not).
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

#include "common.cuh"

namespace ebc {
namespace {

constexpr int kDh = 64;
constexpr int kLdh = kDh + 8;  // row pitch of a head's rows in shared memory (144 B)
constexpr int kWarps = 4;      // 16 rows each
constexpr int kTile = 16 * kWarps;
constexpr int kMaxL = 320;

size_t two_head_smem(int lp) { return (size_t)2 * lp * kLdh * sizeof(bf16); }

// ---- bf16: dQ and the row statistics --------------------------------------

__global__ void __launch_bounds__(kWarps * 32)
attn_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gout,
                   bf16* __restrict__ dqkv, float* __restrict__ stats, int l, int num_heads,
                   int kv_len, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lp = (l + 15) & ~15;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)lp * kLdh;

  const int b = blockIdx.z, h = blockIdx.y;
  const int d = num_heads * kDh, three_d = 3 * d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* base = qkv + (size_t)b * l * three_d + h * kDh;
  const bf16* gbase = gout + (size_t)b * l * d + h * kDh;

  // K_h and V_h of the window (rows >= l zero)
  for (int i = tid; i < lp * (kDh / 8); i += kWarps * 32) {
    const int r = i >> 3, c = i & 7;
    const bf16* row = base + (size_t)(r < l ? r : 0) * three_d + c * 8;
    cp_async16(ks + (size_t)r * kLdh + c * 8, row + d, r < l);
    cp_async16(vs + (size_t)r * kLdh + c * 8, row + 2 * d, r < l);
  }
  cp_async_commit();

  // Q and g fragments of the warp's 16 rows (A operands), from device memory
  const int q0 = blockIdx.x * kTile + warp * 16;
  const int r0 = q0 + g, r1 = q0 + g + 8;
  uint32_t qa[kDh / 16][4], ga[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    auto ld = [&](const bf16* p, int r, size_t pitch, int col) {
      return r < l ? *reinterpret_cast<const uint32_t*>(p + (size_t)r * pitch + col) : 0u;
    };
    qa[kk][0] = ld(base, r0, three_d, c);
    qa[kk][1] = ld(base, r1, three_d, c);
    qa[kk][2] = ld(base, r0, three_d, c + 8);
    qa[kk][3] = ld(base, r1, three_d, c + 8);
    ga[kk][0] = ld(gbase, r0, d, c);
    ga[kk][1] = ld(gbase, r1, d, c);
    ga[kk][2] = ld(gbase, r0, d, c + 8);
    ga[kk][3] = ld(gbase, r1, d, c + 8);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (q0 >= l) return;  // no block-wide barrier follows

  const int nchunks = lp / 16;
  // scores of keys 16j..16j+15 for rows g, g+8: s[0] keys +0..7, s[1] +8..15
  auto scores = [&](int j, float (&s)[2][4]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      uint32_t kb[4];
      ldmatrix_x4(kb, ks + (size_t)(j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdh + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[0], qa[kk], kb[0], kb[1]);
      mma_bf16(s[1], qa[kk], kb[2], kb[3]);
    }
  };
  auto dprobs = [&](int j, float (&dp)[2][4]) {  // dP = g V^T, same layout
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      uint32_t vb[4];
      ldmatrix_x4(vb, vs + (size_t)(j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdh + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(dp[0], ga[kk], vb[0], vb[1]);
      mma_bf16(dp[1], ga[kk], vb[2], vb[3]);
    }
  };

  // sweep 1: row max and sum, online per lane, then merged over the quad
  float mx[2] = {kNegInf, kNegInf}, sm[2] = {0.f, 0.f};
  for (int j = 0; j < nchunks; ++j) {
    float s[2][4];
    scores(j, s);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {  // row g (hr 0) or g + 8 (hr 1)
      float cm = mx[hr];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * 16 + nt * 8 + 2 * t + e < kv_len) cm = fmaxf(cm, s[nt][2 * hr + e] * sm_scale);
      float acc = sm[hr] * expf(mx[hr] - cm);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * 16 + nt * 8 + 2 * t + e < kv_len) acc += expf(s[nt][2 * hr + e] * sm_scale - cm);
      mx[hr] = cm;
      sm[hr] = acc;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[hr], o);
      const float os = __shfl_xor_sync(0xffffffffu, sm[hr], o);
      const float nm = fmaxf(mx[hr], om);
      sm[hr] = sm[hr] * expf(mx[hr] - nm) + os * expf(om - nm);
      mx[hr] = nm;
    }
  }
  // normalized probabilities of a chunk, masked keys exactly 0
  auto probs = [&](int j, float (&s)[2][4]) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        s[nt][e] = j * 16 + nt * 8 + 2 * t + (e & 1) < kv_len
                       ? expf(s[nt][e] * sm_scale - mx[hr]) / sm[hr]
                       : 0.f;
      }
  };

  // sweep 2: D = rowsum(dP P)
  float dsum[2] = {0.f, 0.f};
  for (int j = 0; j < nchunks; ++j) {
    float p[2][4], dp[2][4];
    scores(j, p);
    probs(j, p);
    dprobs(j, dp);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dsum[e >> 1] += dp[nt][e] * p[nt][e];
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) dsum[hr] += __shfl_xor_sync(0xffffffffu, dsum[hr], o);

  // sweep 3: dS = P (dP - D) sm_scale in bf16, dQ += dS K
  float dq[kDh / 8][4];
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
  for (int j = 0; j < nchunks; ++j) {
    float p[2][4], dp[2][4];
    scores(j, p);
    probs(j, p);
    dprobs(j, dp);
    float ds[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nt][e] = p[nt][e] * (dp[nt][e] - dsum[e >> 1]) * sm_scale;
    const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                            pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
    for (int dn = 0; dn < kDh / 16; ++dn) {
      uint32_t kb[4];
      ldmatrix_x4_trans(kb, ks + (size_t)(j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdh +
                                dn * 16 + (lane >> 4) * 8);
      mma_bf16(dq[2 * dn], da, kb[0], kb[1]);
      mma_bf16(dq[2 * dn + 1], da, kb[2], kb[3]);
    }
  }

  bf16* drow0 = dqkv + ((size_t)b * l + r0) * three_d + h * kDh;
  bf16* drow1 = dqkv + ((size_t)b * l + r1) * three_d + h * kDh;
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i) {
    const int c = i * 8 + 2 * t;
    if (r0 < l) *reinterpret_cast<uint32_t*>(drow0 + c) = pack_bf16(dq[i][0], dq[i][1]);
    if (r1 < l) *reinterpret_cast<uint32_t*>(drow1 + c) = pack_bf16(dq[i][2], dq[i][3]);
  }
  if (t == 0) {
    float* st = stats + (size_t)(b * num_heads + h) * 3 * l;
    if (r0 < l) { st[r0] = mx[0]; st[l + r0] = sm[0]; st[2 * l + r0] = dsum[0]; }
    if (r1 < l) { st[r1] = mx[1]; st[l + r1] = sm[1]; st[2 * l + r1] = dsum[1]; }
  }
}

// ---- bf16: dK and dV ------------------------------------------------------

__global__ void __launch_bounds__(kWarps * 32)
attn_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ gout,
                    bf16* __restrict__ dqkv, const float* __restrict__ stats, int l,
                    int num_heads, int kv_len, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lp = (l + 15) & ~15;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + (size_t)lp * kLdh;
  float* mx_s = reinterpret_cast<float*>(gs + (size_t)lp * kLdh);
  float* sm_s = mx_s + lp;
  float* ds_s = sm_s + lp;

  const int b = blockIdx.z, h = blockIdx.y;
  const int d = num_heads * kDh, three_d = 3 * d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* base = qkv + (size_t)b * l * three_d + h * kDh;
  const bf16* gbase = gout + (size_t)b * l * d + h * kDh;

  // Q_h, g_h (rows >= l zero) and the row statistics of every query
  for (int i = tid; i < lp * (kDh / 8); i += kWarps * 32) {
    const int r = i >> 3, c = i & 7;
    const int rr = r < l ? r : 0;
    cp_async16(qs + (size_t)r * kLdh + c * 8, base + (size_t)rr * three_d + c * 8, r < l);
    cp_async16(gs + (size_t)r * kLdh + c * 8, gbase + (size_t)rr * d + c * 8, r < l);
  }
  cp_async_commit();
  const float* st = stats + (size_t)(b * num_heads + h) * 3 * l;
  for (int r = tid; r < lp; r += kWarps * 32) {
    mx_s[r] = r < l ? st[r] : 0.f;
    sm_s[r] = r < l ? st[l + r] : 1.f;
    ds_s[r] = r < l ? st[2 * l + r] : 0.f;
  }

  // K and V fragments of the warp's 16 keys (A operands)
  const int k0 = blockIdx.x * kTile + warp * 16;
  const int r0 = k0 + g, r1 = k0 + g + 8;
  uint32_t ka[kDh / 16][4], va[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    auto ld = [&](int r, int col) {
      return r < l ? *reinterpret_cast<const uint32_t*>(base + (size_t)r * three_d + col) : 0u;
    };
    ka[kk][0] = ld(r0, d + c);
    ka[kk][1] = ld(r1, d + c);
    ka[kk][2] = ld(r0, d + c + 8);
    ka[kk][3] = ld(r1, d + c + 8);
    va[kk][0] = ld(r0, 2 * d + c);
    va[kk][1] = ld(r1, 2 * d + c);
    va[kk][2] = ld(r0, 2 * d + c + 8);
    va[kk][3] = ld(r1, 2 * d + c + 8);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (k0 >= l) return;  // no block-wide barrier follows

  float dk[kDh / 8][4], dv[kDh / 8][4];
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  if (k0 < kv_len) {  // else every key of the warp is masked: dK = dV = 0
    const bool key_ok[2] = {r0 < kv_len, r1 < kv_len};
    for (int i = 0; i < lp / 16; ++i) {
      // S^T and dP^T for keys (rows g, g+8) x queries 16i.. (columns)
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        uint32_t qb[4], gb[4];
        const size_t off = (size_t)(i * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdh + kk * 16 +
                           ((lane >> 3) & 1) * 8;
        ldmatrix_x4(qb, qs + off);
        ldmatrix_x4(gb, gs + off);
        mma_bf16(s[0], ka[kk], qb[0], qb[1]);
        mma_bf16(s[1], ka[kk], qb[2], qb[3]);
        mma_bf16(dp[0], va[kk], gb[0], gb[1]);
        mma_bf16(dp[1], va[kk], gb[2], gb[3]);
      }
      float p[2][4], ds[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = i * 16 + nt * 8 + 2 * t + (e & 1);
          const bool ok = key_ok[e >> 1] && q < l;
          p[nt][e] = ok ? expf(s[nt][e] * sm_scale - mx_s[q]) / sm_s[q] : 0.f;
          ds[nt][e] = p[nt][e] * (dp[nt][e] - ds_s[q]) * sm_scale;
        }
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
      const uint32_t da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
      for (int dn = 0; dn < kDh / 16; ++dn) {
        uint32_t qb[4], gb[4];
        const size_t off = (size_t)(i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdh + dn * 16 +
                           (lane >> 4) * 8;
        ldmatrix_x4_trans(qb, qs + off);
        ldmatrix_x4_trans(gb, gs + off);
        mma_bf16(dk[2 * dn], da, qb[0], qb[1]);
        mma_bf16(dk[2 * dn + 1], da, qb[2], qb[3]);
        mma_bf16(dv[2 * dn], pa, gb[0], gb[1]);
        mma_bf16(dv[2 * dn + 1], pa, gb[2], gb[3]);
      }
    }
  }

  bf16* krow0 = dqkv + ((size_t)b * l + r0) * three_d + d + h * kDh;
  bf16* krow1 = dqkv + ((size_t)b * l + r1) * three_d + d + h * kDh;
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i) {
    const int c = i * 8 + 2 * t;
    if (r0 < l) {
      *reinterpret_cast<uint32_t*>(krow0 + c) = pack_bf16(dk[i][0], dk[i][1]);
      *reinterpret_cast<uint32_t*>(krow0 + d + c) = pack_bf16(dv[i][0], dv[i][1]);
    }
    if (r1 < l) {
      *reinterpret_cast<uint32_t*>(krow1 + c) = pack_bf16(dk[i][2], dk[i][3]);
      *reinterpret_cast<uint32_t*>(krow1 + d + c) = pack_bf16(dv[i][2], dv[i][3]);
    }
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
// (B, H, 3, L) fp32 scratch. Returns the CUDA error code (0 = ok).
extern "C" int ebc_attention_bwd(const void* qkv, const void* g, void* dqkv, void* stats,
                                 int batch, int l, int d, int num_heads, int kv_len,
                                 float sm_scale, void* stream) {
  using namespace ebc;
  if (!attn_shapes_ok(l, d, num_heads, kv_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lp = (l + 15) & ~15;
  const dim3 grid((l + kTile - 1) / kTile, num_heads, batch);
  const size_t smem_q = two_head_smem(lp);
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_dq_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dq_kernel<<<grid, kWarps * 32, smem_q, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
      static_cast<float*>(stats), l, num_heads, kv_len, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem_kv = smem_q + (size_t)3 * lp * sizeof(float);
  e = cudaFuncSetAttribute(attn_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_kv);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dkv_kernel<<<grid, kWarps * 32, smem_kv, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), static_cast<bf16*>(dqkv),
      static_cast<const float*>(stats), l, num_heads, kv_len, sm_scale);
  return (int)cudaGetLastError();
}

// The same in fp32: qkv, g and dqkv fp32, with ebc_attention_bwd's shapes.
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
