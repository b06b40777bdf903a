// LayerNorm -> joint QKV projection -> masked multi-head attention, the
// pre-attention half of every ViT trunk block (ports the Pallas kernel
// clip_ebc_tpu/ops/fused_attention.py: fused_ln_qkv_attention ->
// _ln_qkv_forward's pallas_call, bodies _ln_qkv_kernel + the non-quant
// branch of _pair_attention_body).
//
// Bound. At the flagship shape (B=140 windows, L=229, D=768, H=12, bf16)
// one call does 113.5 GFLOP of projection plus 22.5 GFLOP of QK^T and PV
// and must move ~101 MB (x in, out back, W); at the published H100 SXM
// peaks (989 TFLOP/s bf16 dense, 3.35 TB/s, 700 W) that is 0.14 ms of
// tensor-core work against 0.03 ms of memory: compute-bound, so the design
// is about keeping the tensor cores fed.
//
// Design (two launches, bf16 tensor-core products with fp32 accumulation):
//  * ln_qkv_proj_kernel (wgmma): one block of 2 warpgroups per 64 rows. It
//    copies its rows of x and the first W tiles with cp.async, all in
//    flight at once, then LayerNorms the rows in fp32 (in registers, gamma
//    and beta loaded once a lane) back into shared memory as bf16, the
//    operand the TPU kernel feeds its MXU, while the W tiles land. The rows
//    stay resident, 128B-swizzled, while a 4-stage cp.async ring of
//    256-column x 64-deep W tiles streams all 3D output columns past them,
//    so x is read and normalized once. Each warpgroup multiplies the rows by
//    its 128 columns of the tile with wgmma m64n128k16 straight from shared
//    memory, one batch left in flight across tiles. W is read in torch's
//    (out, in) layout, which is wgmma's K-major B as it stands. Epilogue per
//    256-column chunk: + fp32 bias, round to bf16, stage the tile in the
//    finished W stage, write qkv (B, L, 3D) in 16-byte stores.
//    Where its time goes (chip runs with parts removed): the tensor work is
//    hidden; the x prologue, the LayerNorm, the per-tile barrier and the
//    stores do not overlap, since one block fills an SM's shared memory.
//  * mha_kernel (mma.sync m16n8k16): one block (4 warps) per (64-query
//    tile, head, window). K_h and V_h of the window sit in shared memory;
//    each warp keeps its 16 query rows' scores for the whole key range in
//    registers (the mma accumulators), so the softmax is exact over the row
//    as on the TPU: x sm_scale, keys >= kv_len at kNegInf, fp32 row max /
//    exp / row sum (quad shuffles), P rounded to bf16 straight from the
//    accumulators into the A operand of P.V, O = P V in fp32, then O /
//    rowsum rounded to bf16 into out[b, l, h*64:(h+1)*64]: the rounding
//    points of _pair_attention_body, normalize-after-PV included.
//  * The TPU kernel's head-pair lane packing, 16-row sequence padding and
//    block_b grid blocking fit data to the TPU's 128 lanes; none is carried
//    over. Keys are padded to a multiple of 64 in shared memory only.
//  * Cost of the split: the qkv tensor (B, L, 3D) bf16 makes one round
//    trip through device memory between the launches (148 MB per layer at
//    the flagship shape); fusing it away is a later speed step.
//
// fp32 activations (a model run without --amp; the Pallas kernel takes them
// too) go through a plain-CUDA variant, ebc_ln_qkv_attention_f32: the
// tensor cores take no fp32 operands short of TF32, which would round where
// the plain version does not. Bound at the flagship shape: the same 136
// GFLOP over the 67 TFLOP/s fp32 peak = 2.0 ms, against ~200 MB of memory
// traffic (0.06 ms): compute-bound. Design, simple first:
//  * ln_qkv_proj_f32_kernel: a 128 x 128 output tile per block of 256
//    threads, 8 x 8 outputs a thread (two 4-wide row and column groups 64
//    apart, so the float4 shared-memory reads of a warp do not conflict).
//    The prologue takes the LayerNorm statistics of the block's 128 rows
//    (a warp a row, two passes over registers); each 8-deep step then loads
//    x and W tiles, applies the LayerNorm to x on the way into shared
//    memory (transposed, pitch 132 so those stores do not conflict), and
//    runs the 8 x 8 fp32 FMA outer products. Epilogue: + bias, float4
//    stores. The statistics are taken again by each of the 3D / 128 column
//    blocks of a row tile (from L2); no double buffering yet.
//  * mha_f32_blocked_kernel (redesigned after the first port, whose block of
//    16 warps per (head, window) took a query row a warp and a key a lane,
//    read one scalar of K from shared memory per FMA and broadcast each p
//    by shuffle in P.V: 7.5 TFLOP/s of 67, in 1.45 waves of 192 blocks at a
//    calibration batch): register-blocked SIMT, as flash_f32_kernel and
//    the fp32 attention_bwd are. Bound at a calibration batch (B = 16, L =
//    229): 2.58 GFLOP over 67 TFLOP/s = 0.0385 ms against 45 MB (0.0135
//    ms), so the FMA units bound it, and the design keeps them fed from
//    shared memory. One block of 256 threads per (64-query tile, head,
//    window): 768 blocks at B = 16, 6,720 at the B = 140 of a window
//    forward. The tile's Q rows and all of K_h land by 16-byte cp.async
//    (rows padded to 68 floats). Thread (ty, tx) scores rows 4 ty .. + 3
//    against keys tx + 16 j, each float4 of K feeding 16 FMAs, so the whole
//    score row (the keys padded to a multiple of 16) stays in registers and
//    the softmax is exact over it: x sm_scale, keys >= kv_len at kNegInf,
//    max and sum over the half warp that shares a row, p = exp(s - max)
//    unnormalized. P^T takes K's place in shared memory; O = P V is 4 x 4
//    outputs a thread over the unmasked keys, then O / rowsum, the plain
//    version's order; fp32 throughout. V_h comes in 64-key chunks, two in
//    flight, one landing under the scores and the next in Q's place, so a
//    block takes 103 KB of shared memory at 256 keys and two blocks share
//    an SM (one's loads and barriers run under the other's FMAs; with one
//    block an SM it took 1.25x as long on an H100 SXM at 700 W). Up to 512
//    keys it would take 172 KB: one block an SM.
//
// Limits: head dim 64, D <= 768 (the resident LN rows and the W ring fill
// shared memory; the fp32 LN statistics are held for at most 768 values a
// row), L <= 320 (the score rows live in registers), bf16 or fp32
// activations.

#include "common.cuh"

namespace ebc {
namespace {

// ---- launch 1: LayerNorm + projection ------------------------------------
constexpr int kPM = 64;         // rows per block: one wgmma M
constexpr int kPN = 256;        // output columns per chunk: 2 warpgroups x 128
constexpr int kPK = 64;         // depth of one W tile: one 128-byte swizzle row
constexpr int kPStages = 4;     // W tiles in the ring: ...
constexpr int kPAhead = 2;      // ... tile p + 2 lands while p computes and p - 1 may still be read
constexpr int kPThreads = 256;  // 2 warpgroups
constexpr int kLnChunks = 3;    // 8-column chunks a lane holds in the LayerNorm
constexpr int kMaxDim = kLnChunks * 256;  // d <= 768: LN rows + W ring fill shared memory

// LN rows (d / 64 swizzled k-blocks of 64 rows x 128 B) + the W ring (256
// rows x 128 B a stage) + slack to align the start to 1024 B.
size_t proj_smem_bytes(int d) {
  return (size_t)kPM * d * sizeof(bf16) + (size_t)kPStages * kPN * kPK * sizeof(bf16) + 1024;
}

__global__ void __launch_bounds__(kPThreads, 1)
ln_qkv_proj_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const bf16* __restrict__ w,
                   const float* __restrict__ bias, bf16* __restrict__ qkv,
                   int m, int d, int n, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ws = as + (size_t)kPM * d * sizeof(bf16);
  constexpr int kABlock = kPM * 128;  // bytes of one 64-deep k-block of the LN rows
  constexpr int kWStage = kPN * 128;  // bytes of one W tile

  const int row0 = blockIdx.x * kPM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7;
  const int nk = d / kPK;                        // W tiles per column chunk
  const int total = ((n + kPN - 1) / kPN) * nk;  // W tiles over all chunks

  // W tile p: column chunk p / nk, depth tile p % nk, written swizzled
  auto load_w = [&](int p) {
    unsigned char* dst = ws + (size_t)(p % kPStages) * kWStage;
    const int col0 = (p / nk) * kPN, k0 = (p % nk) * kPK;
    for (int i = tid; i < kPN * 8; i += kPThreads) {
      const int r = i >> 3, c = i & 7;
      const bool ok = col0 + r < n;
      cp_async16(dst + sw128_offset(r, c), w + (size_t)(ok ? col0 + r : 0) * d + k0 + c * 8, ok);
    }
  };
  // address of 8-column chunk cc of LN row r
  auto a_chunk = [&](int r, int cc) { return as + (cc >> 3) * kABlock + sw128_offset(r, cc & 7); };

  // 1. the block's rows of x (zero past m), then the first W tiles: all in
  //    flight at once, the W tiles overlapping the LayerNorm below
  const int xvec = d / 8;
  for (int i = tid; i < kPM * xvec; i += kPThreads) {
    const int r = i / xvec, cc = i - r * xvec;
    const bool ok = row0 + r < m;
    cp_async16(a_chunk(r, cc), x + (size_t)(ok ? row0 + r : 0) * d + cc * 8, ok);
  }
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kPAhead; ++s) {
    if (s < total) load_w(s);
    cp_async_commit();
  }
  cp_async_wait<kPAhead>();
  __syncthreads();

  // 2. LayerNorm in fp32 (two-pass mean / variance over registers), one
  //    warp a row, each lane 8 columns at a time (the same columns in every
  //    row, so their gamma and beta are loaded once), in place
  float gam[kLnChunks][8], bet[kLnChunks][8];
#pragma unroll
  for (int c = 0; c < kLnChunks; ++c) {
    const int cc = c * 32 + lane;
    if (cc < xvec) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 gv = reinterpret_cast<const float4*>(gamma + cc * 8)[h];
        const float4 bv = reinterpret_cast<const float4*>(beta + cc * 8)[h];
        gam[c][4 * h] = gv.x; gam[c][4 * h + 1] = gv.y; gam[c][4 * h + 2] = gv.z; gam[c][4 * h + 3] = gv.w;
        bet[c][4 * h] = bv.x; bet[c][4 * h + 1] = bv.y; bet[c][4 * h + 2] = bv.z; bet[c][4 * h + 3] = bv.w;
      }
    }
  }
  for (int r = warp; r < kPM; r += kPThreads / 32) {
    float v[kLnChunks][8];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kLnChunks; ++c) {
      const int cc = c * 32 + lane;
      if (cc < xvec) {
        const uint4 u = *reinterpret_cast<const uint4*>(a_chunk(r, cc));
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
    for (int c = 0; c < kLnChunks; ++c) {
      if (c * 32 + lane < xvec) {
#pragma unroll
        for (int e = 0; e < 8; ++e) var += (v[c][e] - mu) * (v[c][e] - mu);
      }
    }
    const float rstd = rsqrtf(warp_sum(var) / d + eps);
#pragma unroll
    for (int c = 0; c < kLnChunks; ++c) {
      const int cc = c * 32 + lane;
      if (cc < xvec) {
        uint32_t packed[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          packed[e] = pack_bf16((v[c][2 * e] - mu) * rstd * gam[c][2 * e] + bet[c][2 * e],
                                (v[c][2 * e + 1] - mu) * rstd * gam[c][2 * e + 1] + bet[c][2 * e + 1]);
        *reinterpret_cast<uint4*>(a_chunk(r, cc)) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
  }
  // (the first fence + __syncthreads of the main loop publish the LN rows)

  // 3. for each 256-column chunk: C[64 x 256] = Y[64 x d] . W[chunk, :]^T,
  //    warpgroup wg taking columns [128 wg, 128 wg + 128); the W ring runs
  //    on across chunks
  const int g = lane >> 2, t = lane & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int p = 0; p < total; ++p) {
    const int kt = p % nk;
    cp_async_wait<kPAhead - 1>();
    fence_proxy_async();
    __syncthreads();  // tile p landed for everyone; tile p-2's wgmma is done
    if (p + kPAhead < total) load_w(p + kPAhead);  // into tile p-2's stage
    cp_async_commit();

    const unsigned char* at = as + (size_t)kt * kABlock;
    unsigned char* bt = ws + (size_t)(p % kPStages) * kWStage + wg * 128 * 128;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPK / 16; ++kk)
      wgmma_m64n128k16(acc, sw128_desc(at + kk * 32), sw128_desc(bt + kk * 32), kt > 0 || kk > 0);
    wgmma_commit();

    if (kt == nk - 1) {
      // epilogue of the chunk: + fp32 bias, round to bf16, staged as a
      // 64 x 128 tile (rows of 16 chunks of 16 B, chunk j of row r at
      // j ^ (r % 16)) in this warpgroup's half of tile p's W stage, which
      // only its own finished products read; then written out in 16-byte
      // rows-contiguous stores
      wgmma_wait<0>();
      const int col0 = (p / nk) * kPN + wg * 128;
      const int rl = (warp & 3) * 16 + g;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = col0 + j * 8 + 2 * t;
        const float b0 = col < n ? bias[col] : 0.f, b1 = col < n ? bias[col + 1] : 0.f;
        *reinterpret_cast<uint32_t*>(bt + rl * 256 + ((j ^ (rl & 15)) << 4) + t * 4) =
            pack_bf16(acc[4 * j] + b0, acc[4 * j + 1] + b1);
        *reinterpret_cast<uint32_t*>(bt + (rl + 8) * 256 + ((j ^ ((rl + 8) & 15)) << 4) + t * 4) =
            pack_bf16(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
      }
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");  // this warpgroup only
      for (int i = tid & 127; i < 64 * 16; i += 128) {
        const int rr = i >> 4, c = i & 15;
        const int gr = row0 + rr, gc = col0 + c * 8;
        if (gr < m && gc < n)  // n is a multiple of 8
          *reinterpret_cast<uint4*>(qkv + (size_t)gr * n + gc) =
              *reinterpret_cast<const uint4*>(bt + rr * 256 + ((c ^ (rr & 15)) << 4));
      }
    } else {
      wgmma_wait<1>();  // tile p-1's products are done: its stage may be refilled next
    }
  }
  cp_async_wait<0>();
}

// ---- launch 2: masked attention -------------------------------------------
constexpr int kDh = 64;
constexpr int kLdh = kDh + 8;  // K/V row pitch: 144 B, ldmatrix rows hit distinct banks
constexpr int kAttnWarps = 4;  // 16 query rows each
constexpr int kQTile = 16 * kAttnWarps;
constexpr int kKeyQuantum = 64;  // keys are padded to a multiple of this
constexpr int kMaxKeys = 320;

size_t attn_smem_bytes(int lp) { return (size_t)2 * lp * kLdh * sizeof(bf16); }

// KT = padded key count / 16; the scores of a warp's 16 rows are 2*KT
// accumulator tiles of 16 x 8 held in registers.
template <int KT>
__global__ void __launch_bounds__(kAttnWarps * 32, 2)
mha_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int l, int num_heads,
           int kv_len, float sm_scale) {
  constexpr int LP = KT * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)LP * kLdh;

  const int b = blockIdx.z, h = blockIdx.y;
  const int d = num_heads * kDh, three_d = 3 * d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* base = qkv + (size_t)b * l * three_d + h * kDh;

  // K_h and V_h of this window, all copies in flight at once; rows [l, LP)
  // are zero-filled so 0 * V stays finite
  for (int i = tid; i < LP * (kDh / 8); i += kAttnWarps * 32) {
    const int r = i >> 3, c = i & 7;
    const bf16* row = base + (size_t)(r < l ? r : 0) * three_d + c * 8;
    cp_async16(ks + (size_t)r * kLdh + c * 8, row + d, r < l);
    cp_async16(vs + (size_t)r * kLdh + c * 8, row + 2 * d, r < l);
  }
  cp_async_commit();

  // Q fragments of the warp's 16 rows straight from device memory, while
  // K and V land
  const int q0 = blockIdx.x * kQTile + warp * 16;
  const int r0 = q0 + g, r1 = q0 + g + 8;
  uint32_t qa[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < l ? *reinterpret_cast<const uint32_t*>(base + (size_t)r0 * three_d + c) : 0u;
    qa[kk][1] = r1 < l ? *reinterpret_cast<const uint32_t*>(base + (size_t)r1 * three_d + c) : 0u;
    qa[kk][2] = r0 < l ? *reinterpret_cast<const uint32_t*>(base + (size_t)r0 * three_d + c + 8) : 0u;
    qa[kk][3] = r1 < l ? *reinterpret_cast<const uint32_t*>(base + (size_t)r1 * three_d + c + 8) : 0u;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (q0 >= l) return;  // no block-wide barrier follows

  // S = Q K^T in fp32: tile j holds keys 8j..8j+7
  float s[2 * KT][4];
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      uint32_t kb[4];  // key tiles 2j and 2j+1: {b0, b1} each
      ldmatrix_x4(kb, ks + (size_t)(j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLdh + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * j], qa[kk], kb[0], kb[1]);
      mma_bf16(s[2 * j + 1], qa[kk], kb[2], kb[3]);
    }
  }

  // x sm_scale, mask, row max; rows g and g+8 are spread over the lane quad
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool valid = j * 8 + 2 * t + e < kv_len;
      s[j][e] = valid ? s[j][e] * sm_scale : kNegInf;
      s[j][2 + e] = valid ? s[j][2 + e] * sm_scale : kNegInf;
      mx0 = fmaxf(mx0, s[j][e]);
      mx1 = fmaxf(mx1, s[j][2 + e]);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  // unnormalized softmax: p = exp(s - rowmax) in fp32, rowsum in fp32
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = expf(s[j][e] - mx0);
      s[j][2 + e] = expf(s[j][2 + e] - mx1);
      sum0 += s[j][e];
      sum1 += s[j][2 + e];
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
  }

  // O = bf16(P) V in fp32: score tiles 2j, 2j+1 are the A operand of keys 16j..16j+15
  float o[kDh / 8][4];
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const uint32_t pa[4] = {
        pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
        pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]), pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
    for (int dn = 0; dn < kDh / 16; ++dn) {
      uint32_t vb[4];  // dh tiles 2dn and 2dn+1: {b0, b1} each
      ldmatrix_x4_trans(vb, vs + (size_t)(j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdh +
                                dn * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dn], pa, vb[0], vb[1]);
      mma_bf16(o[2 * dn + 1], pa, vb[2], vb[3]);
    }
  }

  // O / rowsum -> bf16, head-concatenated
  bf16* orow0 = out + ((size_t)b * l + r0) * d + h * kDh;
  bf16* orow1 = out + ((size_t)b * l + r1) * d + h * kDh;
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i) {
    const int c = i * 8 + 2 * t;
    if (r0 < l) *reinterpret_cast<uint32_t*>(orow0 + c) = pack_bf16(o[i][0] / sum0, o[i][1] / sum0);
    if (r1 < l) *reinterpret_cast<uint32_t*>(orow1 + c) = pack_bf16(o[i][2] / sum1, o[i][3] / sum1);
  }
}

template <int KT>
cudaError_t launch_mha(const bf16* qkv, bf16* out, int batch, int l, int num_heads, int kv_len,
                       float sm_scale, cudaStream_t st) {
  const size_t smem = attn_smem_bytes(KT * 16);
  cudaError_t e = cudaFuncSetAttribute(mha_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((l + kQTile - 1) / kQTile, num_heads, batch);
  mha_kernel<KT><<<grid, kAttnWarps * 32, smem, st>>>(qkv, out, l, num_heads, kv_len, sm_scale);
  return cudaGetLastError();
}

// The bf16 attention launch for any l <= kMaxKeys: the padded key count
// picks the instantiation.
cudaError_t launch_mha_any(const bf16* q, bf16* o, int batch, int l, int num_heads, int kv_len,
                           float sm_scale, cudaStream_t st) {
  switch ((l + kKeyQuantum - 1) / kKeyQuantum) {
    case 1: return launch_mha<4>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 2: return launch_mha<8>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 3: return launch_mha<12>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 4: return launch_mha<16>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 5: return launch_mha<20>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- fp32 variant: LayerNorm + projection ----------------------------------
constexpr int kFM = 128, kFN = 128;     // output tile of a block
constexpr int kFK = 8;                  // depth of one step
constexpr int kFThreads = 256;          // 16 x 16 threads, 8 x 8 outputs each
constexpr int kFPitch = kFM + 4;        // transposed tiles: the stores hit distinct banks
constexpr int kFLnVecs = kMaxDim / 128; // float4 a lane holds for the LN statistics

__global__ void __launch_bounds__(kFThreads)
ln_qkv_proj_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ qkv, int m, int d,
                       int n, float eps) {
  __shared__ float mu_s[kFM], rstd_s[kFM];
  __shared__ __align__(16) float as[kFK][kFPitch];
  __shared__ __align__(16) float bs[kFK][kFPitch];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * kFM, col0 = blockIdx.x * kFN;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // 1. LayerNorm statistics of the block's rows: a warp a row, two passes
  //    over registers
  const int xvec = d / 4;
  for (int r = warp; r < kFM; r += kFThreads / 32) {
    const int gr = row0 + r;
    float4 v[kFLnVecs];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kFLnVecs; ++c) {
      const int cc = c * 32 + lane;
      v[c] = gr < m && cc < xvec ? reinterpret_cast<const float4*>(x + (size_t)gr * d)[cc] : zero;
      sum += (v[c].x + v[c].y) + (v[c].z + v[c].w);
    }
    const float mu = warp_sum(sum) / d;
    float var = 0.f;
#pragma unroll
    for (int c = 0; c < kFLnVecs; ++c) {
      if (c * 32 + lane < xvec) {
        var += (v[c].x - mu) * (v[c].x - mu) + (v[c].y - mu) * (v[c].y - mu) +
               (v[c].z - mu) * (v[c].z - mu) + (v[c].w - mu) * (v[c].w - mu);
      }
    }
    const float rstd = rsqrtf(warp_sum(var) / d + eps);
    if (lane == 0) {
      mu_s[r] = mu;
      rstd_s[r] = rstd;
    }
  }
  __syncthreads();

  // 2. C[128 x 128] = LN(x)[rows, :] . W[cols, :]^T, 8 deep a step. This
  //    thread loads 4 depths (lk..lk+3) of row / column lr of each tile, and
  //    computes rows {4 ty, 64 + 4 ty} + 0..3 x columns {4 tx, 64 + 4 tx} + 0..3
  const int tx = tid & 15, ty = tid >> 4;
  const int lr = tid >> 1, lk = (tid & 1) * 4;
  const bool arow = row0 + lr < m, bcol = col0 + lr < n;
  const float* xa = x + (size_t)(arow ? row0 + lr : 0) * d + lk;
  const float* wb = w + (size_t)(bcol ? col0 + lr : 0) * d + lk;
  const float amu = mu_s[lr], arstd = rstd_s[lr];
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kFK) {
    const float4 a = arow ? *reinterpret_cast<const float4*>(xa + k0) : zero;
    const float4 b = bcol ? *reinterpret_cast<const float4*>(wb + k0) : zero;
    const float4 gm = *reinterpret_cast<const float4*>(gamma + k0 + lk);
    const float4 bt = *reinterpret_cast<const float4*>(beta + k0 + lk);
    __syncthreads();  // the previous step's tiles are read
    as[lk][lr] = (a.x - amu) * arstd * gm.x + bt.x;
    as[lk + 1][lr] = (a.y - amu) * arstd * gm.y + bt.y;
    as[lk + 2][lr] = (a.z - amu) * arstd * gm.z + bt.z;
    as[lk + 3][lr] = (a.w - amu) * arstd * gm.w + bt.w;
    bs[lk][lr] = b.x;
    bs[lk + 1][lr] = b.y;
    bs[lk + 2][lr] = b.z;
    bs[lk + 3][lr] = b.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // 3. + bias, float4 stores (n is a multiple of 8: a 4-column group is all
  //    inside or all outside)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (gr >= m) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gc = col0 + 64 * hh + 4 * tx;
      if (gc >= n) continue;
      const float4 bb = *reinterpret_cast<const float4*>(bias + gc);
      *reinterpret_cast<float4*>(qkv + (size_t)gr * n + gc) =
          make_float4(acc[i][4 * hh] + bb.x, acc[i][4 * hh + 1] + bb.y, acc[i][4 * hh + 2] + bb.z,
                      acc[i][4 * hh + 3] + bb.w);
    }
  }
}

// ---- fp32 variant: masked attention (register-blocked SIMT) ------------------
constexpr int kFAttnTile = 64;          // query rows of a block
constexpr int kFAttnPitch = kDh + 4;    // 68: Q, K and P^T rows; a half warp's float4s hit distinct banks

constexpr int kFVChunk = 64;            // keys of a V chunk in P.V

// The Q tile (a V chunk after the scores), K_h (P^T after the scores) for
// LP padded keys, and a second V chunk.
size_t attn_f32_smem_bytes(int lp) {
  return ((size_t)(kFAttnTile + lp) * kFAttnPitch + (size_t)kFVChunk * kDh) * sizeof(float);
}

// rows [0, n) of a (rows, 64) fp32 slice of row pitch ``pitch`` (elements)
// into shared memory at row pitch ``spitch``, rows [n, total) zero
// (cp.async, uncommitted)
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, int n, int total,
                                               size_t pitch, int spitch) {
  for (int i = threadIdx.x; i < total * (kDh / 4); i += kFThreads) {
    const int r = i >> 4, c = (i & 15) * 4;
    cp_async16(dst + r * spitch + c, src + (size_t)(r < n ? r : 0) * pitch + c, r < n);
  }
}

// One block of 256 threads (16 x 16) per (64-query tile, head, window); NJ =
// keys a thread scores, the key count padded to 16 NJ. Thread (ty, tx)
// scores rows 4 ty + i against keys tx + 16 j, the whole row in registers,
// then computes rows 4 ty + i x columns 4 tx + c of O. Two blocks share an
// SM up to 256 keys.
template <int NJ>
__global__ void __launch_bounds__(kFThreads, NJ <= 16 ? 2 : 1)
mha_f32_blocked_kernel(const float* __restrict__ qkv, float* __restrict__ out, int l, int num_heads,
                       int kv_len, float sm_scale) {
  constexpr int LP = 16 * NJ;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                           // [kFAttnTile][kFAttnPitch]: Q, then V chunks 1, 3, ...
  float* ks = qs + kFAttnTile * kFAttnPitch; // [LP][kFAttnPitch]: K, then P^T
  float* vx = ks + LP * kFAttnPitch;         // [kFVChunk][kDh]: V chunks 0, 2, ...
  const int q0 = blockIdx.x * kFAttnTile, h = blockIdx.y, b = blockIdx.z;
  const int d = num_heads * kDh, three_d = 3 * d;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* base = qkv + (size_t)b * l * three_d + h * kDh;
  const int nk = min(l, kv_len);  // keys of P.V: p is exactly 0 at the others
  const int n_chunks = (nk + kFVChunk - 1) / kFVChunk;
  auto stage_v = [&](int c) {  // V chunk c into its buffer; always a commit group
    if (c < n_chunks)
      stage_rows_f32(c & 1 ? qs : vx, base + 2 * d + (size_t)c * kFVChunk * three_d,
                     l - c * kFVChunk, kFVChunk, three_d, kDh);
    cp_async_commit();
  };

  // Q and K land first; V chunk 0 lands while the scores are computed
  stage_rows_f32(qs, base + (size_t)q0 * three_d, l - q0, kFAttnTile, three_d, kFAttnPitch);
  stage_rows_f32(ks, base + d, l, LP, three_d, kFAttnPitch);
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

  // x sm_scale, keys >= kv_len (padding included) at kNegInf; the exact row
  // max and sum over the 16 lanes of a half warp that share the row; p =
  // exp(s - max) unnormalized
  float sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[i][j] = tx + 16 * j < kv_len ? s[i][j] * sm_scale : kNegInf;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sm = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[i][j] = expf(s[i][j] - mx);
      sm += s[i][j];
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) sm += __shfl_xor_sync(0xffffffffu, sm, o);
    sum[i] = sm;
  }
  __syncthreads();  // Q and K are read: P^T takes K's place, V chunk 1 Q's
  stage_v(1);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    *reinterpret_cast<float4*>(ks + (tx + 16 * j) * kFAttnPitch + 4 * ty) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

  // O = P V chunk by chunk (chunk c + 1 lands while c is multiplied), then
  // O / rowsum: the order of the plain version
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r < l)
      *reinterpret_cast<float4*>(out + ((size_t)b * l + r) * d + h * kDh + 4 * tx) =
          make_float4(o[i][0] / sum[i], o[i][1] / sum[i], o[i][2] / sum[i], o[i][3] / sum[i]);
  }
}

template <int NJ>
cudaError_t launch_mha_f32(const float* qkv, float* out, int batch, int l, int num_heads,
                           int kv_len, float sm_scale, cudaStream_t st) {
  const size_t smem = attn_f32_smem_bytes(16 * NJ);
  cudaError_t e = cudaFuncSetAttribute(mha_f32_blocked_kernel<NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((l + kFAttnTile - 1) / kFAttnTile, num_heads, batch);
  mha_f32_blocked_kernel<NJ><<<grid, kFThreads, smem, st>>>(qkv, out, l, num_heads, kv_len, sm_scale);
  return cudaGetLastError();
}

// The fp32 attention launch for any l <= kMaxKeys: keys padded to a
// multiple of 16 pick the instantiation.
cudaError_t launch_mha_f32_any(const float* q, float* o, int batch, int l, int num_heads,
                               int kv_len, float sm_scale, cudaStream_t st) {
  switch ((l + 15) / 16) {
    case 1: return launch_mha_f32<1>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 2: return launch_mha_f32<2>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 3: return launch_mha_f32<3>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 4: return launch_mha_f32<4>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 5: return launch_mha_f32<5>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 6: return launch_mha_f32<6>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 7: return launch_mha_f32<7>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 8: return launch_mha_f32<8>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 9: return launch_mha_f32<9>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 10: return launch_mha_f32<10>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 11: return launch_mha_f32<11>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 12: return launch_mha_f32<12>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 13: return launch_mha_f32<13>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 14: return launch_mha_f32<14>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 15: return launch_mha_f32<15>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 16: return launch_mha_f32<16>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 17: return launch_mha_f32<17>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 18: return launch_mha_f32<18>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 19: return launch_mha_f32<19>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    case 20: return launch_mha_f32<20>(q, o, batch, l, num_heads, kv_len, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

bool attention_shape_ok(int l, int d, int num_heads, int kv_len) {
  return d == num_heads * kDh && d <= kMaxDim && l >= 1 && l <= kMaxKeys && kv_len >= 1 &&
         kv_len <= l;
}

cudaError_t launch_proj(const void* x, const void* gamma, const void* beta, const void* w,
                        const void* bias, void* qkv, int m, int d, float eps, cudaStream_t st) {
  const size_t proj_smem = proj_smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(ln_qkv_proj_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)proj_smem);
  if (e != cudaSuccess) return e;
  ln_qkv_proj_kernel<<<(m + kPM - 1) / kPM, kPThreads, proj_smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(qkv), m, d, 3 * d, eps);
  return cudaGetLastError();
}

cudaError_t launch_proj_f32(const void* x, const void* gamma, const void* beta, const void* w,
                            const void* bias, void* qkv, int m, int d, float eps, cudaStream_t st) {
  const int n = 3 * d;
  const dim3 grid((n + kFN - 1) / kFN, (m + kFM - 1) / kFM);
  ln_qkv_proj_f32_kernel<<<grid, kFThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(qkv), m, d, n, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ebc

// x (B, L, D) bf16; gamma, beta (D,) fp32; w (3D, D) bf16 in torch Linear
// (out, in) layout; bias (3D,) fp32; qkv (B, L, 3D) bf16 scratch; out
// (B, L, D) bf16. Returns the CUDA error code of the launches (0 = ok).
extern "C" int ebc_ln_qkv_attention(const void* x, const void* gamma, const void* beta,
                                    const void* w, const void* bias, void* qkv, void* out,
                                    int batch, int l, int d, int num_heads, int kv_len,
                                    float sm_scale, float eps, void* stream) {
  using namespace ebc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!attention_shape_ok(l, d, num_heads, kv_len)) return (int)cudaErrorInvalidValue;

  cudaError_t e = launch_proj(x, gamma, beta, w, bias, qkv, batch * l, d, eps, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_mha_any(static_cast<const bf16*>(qkv), static_cast<bf16*>(out), batch, l,
                             num_heads, kv_len, sm_scale, st);
}

// The masked attention alone, from a precomputed qkv (B, L, 3D) bf16 to out
// (B, L, D) bf16 (ports clip_ebc_tpu/ops/fused_attention.py:
// fused_qkv_attention -> _forward's pallas_call, body _kernel ->
// _pair_attention_body): the mha_kernel launch above as an entry of its
// own. It is what a block runs when the LayerNorm and the projection stay
// outside the kernel: a calibration pass, dynamic int8, fuse_ln_mode="off";
// the int8 projection kernel (csrc/fused_attention_int8.cu) is followed by
// it too. Bound at a calibration batch (B=16, L=229, D=768): 2.6 GFLOP of
// QK^T and PV against 22.5 MB (qkv in, out back): 0.007 ms of memory over
// 0.003 ms of tensor work, so bytes bound it; K_h and V_h are read once
// per 64-query tile (4 times at L = 229), from L2 after the first.
extern "C" int ebc_qkv_attention(const void* qkv, void* out, int batch, int l, int d,
                                 int num_heads, int kv_len, float sm_scale, void* stream) {
  using namespace ebc;
  if (!attention_shape_ok(l, d, num_heads, kv_len)) return (int)cudaErrorInvalidValue;
  return (int)launch_mha_any(static_cast<const bf16*>(qkv), static_cast<bf16*>(out), batch, l,
                             num_heads, kv_len, sm_scale, static_cast<cudaStream_t>(stream));
}

// The same in fp32 (mha_f32_blocked_kernel).
extern "C" int ebc_qkv_attention_f32(const void* qkv, void* out, int batch, int l, int d,
                                     int num_heads, int kv_len, float sm_scale, void* stream) {
  using namespace ebc;
  if (!attention_shape_ok(l, d, num_heads, kv_len)) return (int)cudaErrorInvalidValue;
  return (int)launch_mha_f32_any(static_cast<const float*>(qkv), static_cast<float*>(out), batch, l,
                                 num_heads, kv_len, sm_scale, static_cast<cudaStream_t>(stream));
}

// The first launch of ebc_ln_qkv_attention alone, qkv = LN(x) W^T + bias
// in bf16 (M = B L rows): the recompute of the frozen backward
// (csrc/fused_attention_bwd.cu).
extern "C" int ebc_ln_qkv_proj(const void* x, const void* gamma, const void* beta, const void* w,
                               const void* bias, void* qkv, int m, int d, float eps,
                               void* stream) {
  using namespace ebc;
  if (m < 1 || d < 64 || d % 64 || d > kMaxDim) return (int)cudaErrorInvalidValue;
  return (int)launch_proj(x, gamma, beta, w, bias, qkv, m, d, eps,
                          static_cast<cudaStream_t>(stream));
}

// The first launch of ebc_ln_qkv_attention_f32 alone (ln_qkv_proj_f32_kernel),
// qkv = LN(x) W^T + bias in fp32: timed apart from the attention launch.
extern "C" int ebc_ln_qkv_proj_f32(const void* x, const void* gamma, const void* beta,
                                   const void* w, const void* bias, void* qkv, int m, int d,
                                   float eps, void* stream) {
  using namespace ebc;
  if (m < 1 || d < 64 || d % 64 || d > kMaxDim) return (int)cudaErrorInvalidValue;
  return (int)launch_proj_f32(x, gamma, beta, w, bias, qkv, m, d, eps,
                              static_cast<cudaStream_t>(stream));
}

// The same in fp32: x, w, qkv and out fp32, with ebc_ln_qkv_attention's
// shapes and layouts.
extern "C" int ebc_ln_qkv_attention_f32(const void* x, const void* gamma, const void* beta,
                                        const void* w, const void* bias, void* qkv, void* out,
                                        int batch, int l, int d, int num_heads, int kv_len,
                                        float sm_scale, float eps, void* stream) {
  using namespace ebc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!attention_shape_ok(l, d, num_heads, kv_len)) return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_proj_f32(x, gamma, beta, w, bias, qkv, batch * l, d, eps, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_mha_f32_any(static_cast<const float*>(qkv), static_cast<float*>(out), batch, l,
                                 num_heads, kv_len, sm_scale, st);
}
