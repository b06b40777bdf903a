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
//  * fp32 (training without --amp): the same split in plain CUDA,
//    attn_bwd_dq_f32_kernel and attn_bwd_dkv_f32_kernel, one block of 8
//    warps per (64-row tile, head, window), a warp a query row (or key
//    row) with the whole other side in shared memory (pitch 65, so lane j
//    reads row j conflict-free) and the 64-wide row in registers; products
//    broadcast by warp shuffle, as in mha_f32_kernel. Every product reads
//    one fp32 operand from shared memory, so shared-memory bandwidth, not
//    the FMA rate, bounds it; the other side (~120 KB at L = 229) allows
//    one block per SM.
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

// ---- fp32: a warp a row ---------------------------------------------------

constexpr int kFWarps = 8;
constexpr int kFRows = 64;                   // rows of one block's tile
constexpr int kFPitch = kDh + 1;             // lane j reads row j from its own bank
constexpr int kFPerLane = kMaxL / 32;        // rows of the other side a lane holds

size_t f32_smem(int l) { return (size_t)l * 2 * kFPitch * sizeof(float) + (size_t)3 * l * sizeof(float); }

// Copies columns [col, col + 64) of ``rows`` rows (pitch ``pitch``) into
// shared memory at pitch kFPitch.
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, int rows, size_t pitch) {
  for (int i = threadIdx.x; i < rows * kDh; i += kFWarps * 32) {
    const int r = i / kDh, c = i % kDh;
    dst[r * kFPitch + c] = src[(size_t)r * pitch + c];
  }
}

__device__ __forceinline__ void load_row_f32(float (&v)[kDh], const float* src) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int c = 0; c < kDh / 4; ++c) {
    const float4 t4 = p[c];
    v[4 * c] = t4.x;
    v[4 * c + 1] = t4.y;
    v[4 * c + 2] = t4.z;
    v[4 * c + 3] = t4.w;
  }
}

__global__ void __launch_bounds__(kFWarps * 32)
attn_bwd_dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ gout,
                       float* __restrict__ dqkv, float* __restrict__ stats, int l,
                       int num_heads, int kv_len, float sm_scale) {
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;
  float* vs = fsm + (size_t)l * kFPitch;
  const int h = blockIdx.x, b = blockIdx.y, row_end = min(l, (int)(blockIdx.z + 1) * kFRows);
  const int d = num_heads * kDh, three_d = 3 * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* base = qkv + (size_t)b * l * three_d + h * kDh;
  const float* gbase = gout + (size_t)b * l * d + h * kDh;
  stage_rows_f32(ks, base + d, l, three_d);
  stage_rows_f32(vs, base + 2 * d, l, three_d);
  __syncthreads();

  float* st = stats + (size_t)(b * num_heads + h) * 3 * l;
  for (int r = blockIdx.z * kFRows + warp; r < row_end; r += kFWarps) {
    float q[kDh];
    load_row_f32(q, base + (size_t)r * three_d);
    // lane holds keys lane, lane + 32, ...: scores, softmax over the row
    float p[kFPerLane];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kFPerLane; ++i) {
      const int j = i * 32 + lane;
      float acc = 0.f;
      if (j < l) {
        const float* kr = ks + j * kFPitch;
#pragma unroll
        for (int c = 0; c < kDh; ++c) acc = fmaf(q[c], kr[c], acc);
      }
      p[i] = j < kv_len ? acc * sm_scale : kNegInf;
      mx = fmaxf(mx, p[i]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kFPerLane; ++i) {
      p[i] = i * 32 + lane < l ? expf(p[i] - mx) : 0.f;
      sum += p[i];
    }
    sum = warp_sum(sum);
    float gr[kDh];
    load_row_f32(gr, gbase + (size_t)r * d);
    float dp[kFPerLane];
    float dsum = 0.f;
#pragma unroll
    for (int i = 0; i < kFPerLane; ++i) {
      const int j = i * 32 + lane;
      p[i] = p[i] / sum;
      float acc = 0.f;
      if (j < l) {
        const float* vr = vs + j * kFPitch;
#pragma unroll
        for (int c = 0; c < kDh; ++c) acc = fmaf(gr[c], vr[c], acc);
      }
      dp[i] = acc;
      dsum += acc * p[i];
    }
    dsum = warp_sum(dsum);
    // dQ = dS K: lane owns columns lane and lane + 32
    float o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int i = 0; i < kFPerLane; ++i) {
      if (i * 32 >= l) break;
      const float ds = p[i] * (dp[i] - dsum) * sm_scale;
      const int nj = min(32, l - i * 32);
      for (int jj = 0; jj < nj; ++jj) {
        const float dsj = __shfl_sync(0xffffffffu, ds, jj);
        const float* kr = ks + (i * 32 + jj) * kFPitch;
        o0 = fmaf(dsj, kr[lane], o0);
        o1 = fmaf(dsj, kr[lane + 32], o1);
      }
    }
    float* drow = dqkv + ((size_t)b * l + r) * three_d + h * kDh;
    drow[lane] = o0;
    drow[lane + 32] = o1;
    if (lane == 0) {
      st[r] = mx;
      st[l + r] = sum;
      st[2 * l + r] = dsum;
    }
  }
}

__global__ void __launch_bounds__(kFWarps * 32)
attn_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ gout,
                        float* __restrict__ dqkv, const float* __restrict__ stats, int l,
                        int num_heads, int kv_len, float sm_scale) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* gs = fsm + (size_t)l * kFPitch;
  float* mx_s = gs + (size_t)l * kFPitch;
  float* sm_s = mx_s + l;
  float* ds_s = sm_s + l;
  const int h = blockIdx.x, b = blockIdx.y, row_end = min(l, (int)(blockIdx.z + 1) * kFRows);
  const int d = num_heads * kDh, three_d = 3 * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* base = qkv + (size_t)b * l * three_d + h * kDh;
  const float* gbase = gout + (size_t)b * l * d + h * kDh;
  stage_rows_f32(qs, base, l, three_d);
  stage_rows_f32(gs, gbase, l, d);
  const float* st = stats + (size_t)(b * num_heads + h) * 3 * l;
  for (int r = threadIdx.x; r < 3 * l; r += kFWarps * 32) mx_s[r] = st[r];
  __syncthreads();

  for (int r = blockIdx.z * kFRows + warp; r < row_end; r += kFWarps) {
    float* krow = dqkv + ((size_t)b * l + r) * three_d + d + h * kDh;
    if (r >= kv_len) {  // a masked key: P = 0 for every query
      krow[lane] = krow[lane + 32] = 0.f;
      krow[d + lane] = krow[d + lane + 32] = 0.f;
      continue;
    }
    float k[kDh], v[kDh];
    load_row_f32(k, base + (size_t)r * three_d + d);
    load_row_f32(v, base + (size_t)r * three_d + 2 * d);
    // lane holds queries lane, lane + 32, ...
    float p[kFPerLane], ds[kFPerLane];
#pragma unroll
    for (int i = 0; i < kFPerLane; ++i) {
      const int q = i * 32 + lane;
      p[i] = ds[i] = 0.f;
      if (q < l) {
        const float* qr = qs + q * kFPitch;
        const float* gr = gs + q * kFPitch;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < kDh; ++c) {
          s = fmaf(qr[c], k[c], s);
          dp = fmaf(gr[c], v[c], dp);
        }
        p[i] = expf(s * sm_scale - mx_s[q]) / sm_s[q];
        ds[i] = p[i] * (dp - ds_s[q]) * sm_scale;
      }
    }
    // dK = dS^T Q, dV = P^T g: lane owns columns lane and lane + 32
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int i = 0; i < kFPerLane; ++i) {
      if (i * 32 >= l) break;
      const int nq = min(32, l - i * 32);
      for (int qq = 0; qq < nq; ++qq) {
        const float dsq = __shfl_sync(0xffffffffu, ds[i], qq);
        const float pq = __shfl_sync(0xffffffffu, p[i], qq);
        const float* qr = qs + (i * 32 + qq) * kFPitch;
        const float* gr = gs + (i * 32 + qq) * kFPitch;
        k0 = fmaf(dsq, qr[lane], k0);
        k1 = fmaf(dsq, qr[lane + 32], k1);
        v0 = fmaf(pq, gr[lane], v0);
        v1 = fmaf(pq, gr[lane + 32], v1);
      }
    }
    krow[lane] = k0;
    krow[lane + 32] = k1;
    krow[d + lane] = v0;
    krow[d + lane + 32] = v1;
  }
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
  const dim3 grid(num_heads, batch, (l + kFRows - 1) / kFRows);
  const size_t smem = f32_smem(l);
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_dq_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dq_f32_kernel<<<grid, kFWarps * 32, smem, st>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(g), static_cast<float*>(dqkv),
      static_cast<float*>(stats), l, num_heads, kv_len, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(attn_bwd_dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_dkv_f32_kernel<<<grid, kFWarps * 32, smem, st>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(g), static_cast<float*>(dqkv),
      static_cast<const float*>(stats), l, num_heads, kv_len, sm_scale);
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
