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
//  * the attention: the wgmma body of csrc/attention_short.cuh with P
//    normalized after P V (redesigned after the first port, mha_kernel:
//    mma.sync fed by ldmatrix, a block of 4 warps per (64-query tile, head,
//    window), which restaged a (window, head)'s K and V from L2 once per
//    query tile, waited on all its loads before any product and ran expf
//    and two divisions per output pair). A persistent block of three
//    warpgroups on each SM stages a (window, head)'s Q, K and V once by
//    TMA, the next one's loads in flight under its products, its query
//    tiles shared out in turn; S = Q K^T is wgmma from
//    shared memory, the softmax exact over the row in registers: x
//    sm_scale, keys >= kv_len at kNegInf, p = exp(s - rowmax) unnormalized
//    (ex2.approx), the fp32 row sum; P rounded to bf16 goes from the
//    accumulators into the register A operand of P V, O = P V in fp32,
//    then O x (1 / rowsum) rounded to bf16 into out[b, l,
//    h*64:(h+1)*64]: the rounding points of _pair_attention_body,
//    normalize-after-PV included. q, k and v are read from the packed qkv
//    by (window, head, row) strides (a row pitch of 3D); keys past kv_len
//    are not loaded (zeros, masked: p = 0 there as at a masked key).
//  * The TPU kernel's head-pair lane packing, 16-row sequence padding and
//    block_b grid blocking fit data to the TPU's 128 lanes; none is carried
//    over. Keys are padded to a multiple of 128 in shared memory only.
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
//  * the attention: the register-blocked SIMT body of
//    csrc/attention_short.cuh with P normalized after P V (redesigned after
//    the first port, mha_f32_kernel, whose block of 16 warps per (head,
//    window) took a query row a warp and a key a lane, read one scalar of K
//    from shared memory per FMA and broadcast each p by shuffle in P.V: 7.5
//    TFLOP/s of 67, in 1.45 waves of 192 blocks at a calibration batch).
//    Bound at a calibration batch (B = 16, L = 229): 2.58 GFLOP over 67
//    TFLOP/s = 0.0385 ms against 45 MB (0.0135 ms), so the FMA units bound
//    it. One block of 256 threads per (64-query tile, head, window): 768
//    blocks at B = 16, 6,720 at the B = 140 of a window forward; 4 rows x
//    16 keys a thread with the whole row in registers, P^T in K's place, V
//    in 64-key chunks so two blocks share an SM (with one block an SM it
//    took 1.25x as long on an H100 SXM at 700 W). Then O / rowsum, the plain
//    version's order; fp32 throughout.
//
// Limits: head dim 64, D <= 768 (the resident LN rows and the W ring fill
// shared memory; the fp32 LN statistics are held for at most 768 values a
// row), L <= 320 (the float kernels' route; the bodies take 512 keys, ROADMAP
// Queue 2), sm_scale > 0 (the wgmma body takes the row max of the raw
// scores), bf16 or fp32 activations.

#include "attention_short.cuh"

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

// ---- launch 2: masked attention (csrc/attention_short.cuh) -----------------
constexpr int kMaxKeys = 320;

// The short-attention arguments of the heads of a packed qkv (B, L, 3D) of
// element type T (q, k, v at column offsets 0, D, 2D; head h at 64 h),
// written to out (B, L, D): keys past kv_len land as zeros and are masked.
template <typename T>
FlashArgs packed_args(const void* qkv, void* out, int batch, int l, int num_heads, int kv_len,
                      float sm_scale) {
  const long long d = (long long)num_heads * kDh, in_row = 3 * d;
  const T* base = static_cast<const T*>(qkv);
  FlashArgs a;
  a.q = base;
  a.k = base + d;
  a.v = base + 2 * d;
  a.o = out;
  a.b = batch;
  a.h = num_heads;
  a.lq = l;
  a.lk = kv_len;
  for (int i = 0; i < 3; ++i) {
    long long* st = i == 0 ? a.qs : i == 1 ? a.ks : a.vs;
    st[0] = l * in_row;
    st[1] = kDh;
    st[2] = in_row;
  }
  a.os[0] = l * d;
  a.os[1] = kDh;
  a.os[2] = d;
  a.scale = sm_scale;
  a.causal = 0;
  return a;
}

// The bf16 attention launch (the wgmma body, P normalized after P V) and
// the fp32 one (the register-blocked body), for any kv_len <= l <= kMaxKeys.
cudaError_t launch_mha_any(const void* qkv, void* out, int batch, int l, int num_heads, int kv_len,
                           float sm_scale, cudaStream_t st) {
  return launch_short_bf16_any<true, (kMaxKeys + kSChunk - 1) / kSChunk>(
      packed_args<bf16>(qkv, out, batch, l, num_heads, kv_len, sm_scale), st);
}

cudaError_t launch_mha_f32_any(const void* qkv, void* out, int batch, int l, int num_heads,
                               int kv_len, float sm_scale, cudaStream_t st) {
  return launch_short_f32_any<true, kMaxKeys / 16>(
      packed_args<float>(qkv, out, batch, l, num_heads, kv_len, sm_scale), st);
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

bool attention_shape_ok(int l, int d, int num_heads, int kv_len, float sm_scale) {
  return d == num_heads * kDh && d <= kMaxDim && l >= 1 && l <= kMaxKeys && kv_len >= 1 &&
         kv_len <= l && sm_scale > 0.f;
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
  if (!attention_shape_ok(l, d, num_heads, kv_len, sm_scale)) return (int)cudaErrorInvalidValue;

  cudaError_t e = launch_proj(x, gamma, beta, w, bias, qkv, batch * l, d, eps, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_mha_any(qkv, out, batch, l, num_heads, kv_len, sm_scale, st);
}

// The masked attention alone, from a precomputed qkv (B, L, 3D) bf16 to out
// (B, L, D) bf16 (ports clip_ebc_tpu/ops/fused_attention.py:
// fused_qkv_attention -> _forward's pallas_call, body _kernel ->
// _pair_attention_body): the attention launch above as an entry of its
// own. It is what a block runs when the LayerNorm and the projection stay
// outside the kernel: a calibration pass, dynamic int8, fuse_ln_mode="off";
// the int8 projection kernel (csrc/fused_attention_int8.cu) is followed by
// it too. Bound at a calibration batch (B=16, L=229, D=768): 2.6 GFLOP of
// QK^T and PV against 22.5 MB (qkv in, out back): 0.007 ms of memory over
// 0.003 ms of tensor work, so bytes bound it; each (window, head)'s K and V
// is read once.
extern "C" int ebc_qkv_attention(const void* qkv, void* out, int batch, int l, int d,
                                 int num_heads, int kv_len, float sm_scale, void* stream) {
  using namespace ebc;
  if (!attention_shape_ok(l, d, num_heads, kv_len, sm_scale)) return (int)cudaErrorInvalidValue;
  return (int)launch_mha_any(qkv, out, batch, l, num_heads, kv_len, sm_scale,
                             static_cast<cudaStream_t>(stream));
}

// The same in fp32 (the register-blocked body).
extern "C" int ebc_qkv_attention_f32(const void* qkv, void* out, int batch, int l, int d,
                                     int num_heads, int kv_len, float sm_scale, void* stream) {
  using namespace ebc;
  if (!attention_shape_ok(l, d, num_heads, kv_len, sm_scale)) return (int)cudaErrorInvalidValue;
  return (int)launch_mha_f32_any(qkv, out, batch, l, num_heads, kv_len, sm_scale,
                                 static_cast<cudaStream_t>(stream));
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
  if (!attention_shape_ok(l, d, num_heads, kv_len, sm_scale)) return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_proj_f32(x, gamma, beta, w, bias, qkv, batch * l, d, eps, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_mha_f32_any(qkv, out, batch, l, num_heads, kv_len, sm_scale, st);
}
