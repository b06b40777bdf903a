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
//  * ln_qkv_proj_kernel, launch 1 (ports _ln_qkv_kernel's float branch,
//    site :541): LayerNorm in fp32 (two passes over a row), y rounded to
//    bf16, y . W^T with fp32 accumulation, + fp32 bias, one rounding to
//    bf16 into qkv (M, 3D). Bound at a window forward (M = 140 x 229 =
//    32,060, D = 768, N = 2304): 113.5 GFLOP over 989 TFLOP/s = 0.115 ms
//    against ~200 MB (0.06 ms), so the tensor cores bound it; at a training
//    step (M = 3,664) 0.013 ms.
//    Design (wgmma, TMA, sm_90a; redesigned after the first port, one block
//    of two warpgroups per 64 rows that streamed all of W from L2 for each
//    64 rows through a cp.async ring with a block-wide barrier per tile:
//    0.468 ms at B = 140, 0.114 at B = 16 on an H100 SXM at 700 W; a copy
//    of it with W loaded once and reused took 0.303, without stores 0.422,
//    without the LayerNorm 0.450, so its L2 stream of W led). One
//    persistent block on each SM walks items of 128 rows x a part of the
//    columns (parts chosen per call so that ~every SM has work: 1 at B =
//    140, 9 at B = 16); each of two warpgroups owns 64 rows. Its LN rows
//    stay resident for the item: the first 384 columns as the register A
//    operand of wgmma m64n128k16 (96 registers a thread; they pass through
//    the shared tiles and ldmatrix), the rest in shared memory, 128B-
//    swizzled. W, in torch's (out, in) layout (wgmma's K-major B as it
//    stands), comes by TMA in steps of two 64-deep boxes of 128 columns
//    into a 3-stage ring on per-stage mbarriers; step s is issued while
//    step s - 1's products finish, and the last of the 8 warps done with a
//    stage refills it (no producer warp: the consumers need 224 registers).
//    128 rows an item halve the first port's L2 reads of W (0.89 GB). The
//    epilogue (+ bias, bf16) stages each warpgroup's 64 x 128 tile as two
//    swizzled boxes that one thread writes out by TMA, rows past M clipped.
//    Where the time goes (timing-only copies, PERF.md): without the
//    LayerNorm 0.229 of 0.253 ms; without any wgmma 0.167: the W stream's
//    waits, the LayerNorm and the epilogue run in series with the products
//    (both warpgroups do each at once), so the tensor time adds to them.
//    Tried and dropped: the register tiles built from 4-byte loads of x
//    (0.268; the load instructions, not the math, took the LayerNorm's
//    time), 4-byte stores from the accumulators instead of the staged TMA
//    stores, with 16-byte ring stages and 8 of them or with 4 of 32 KB
//    (0.39-0.40 ms: the scattered stores cost more than the deeper ring
//    saved), each step's products finished before the next wait (0.253).
//    Past D = 768 (ViT-L's D = 1024, 16 heads) 128 LN rows of 1024 values
//    (256 KB) do not fit in shared memory (227 KB a block). The wide layout
//    (ProjCfg) keeps the same items, warpgroups and 6 register tiles; the
//    other 10 tiles of a warpgroup's rows (160 KB for both) stay shared, the
//    ring's 3 stages hold one 64-deep W box each (48 KB), and a warpgroup
//    stages one 64 x 64 output box at a time (231,488 bytes in all). Bound
//    at a ViT-L window forward (M = 140 x 289 = 40,460, D = 1024, N =
//    3072): 254.6 GFLOP over 989 TFLOP/s = 0.257 ms against 338 MB (0.10
//    ms): the tensor cores bound it.
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
// Limits: head dim 64, D <= 1024 (the resident LN rows and the W ring fill
// shared memory; the fp32 LN statistics hold a row of at most 1024 values
// in registers), L <= 320 (the float kernels' route; the bodies take 512 keys, ROADMAP
// Queue 2), sm_scale > 0 (the wgmma body takes the row max of the raw
// scores), bf16 or fp32 activations.

#include "attention_short.cuh"

namespace ebc {
namespace {

// ---- launch 1: LayerNorm + projection ------------------------------------
constexpr int kMaxDim = 1024;    // the widest model (ViT-L); past D = 768 the wide layout below
constexpr int kPM = 128;         // rows of an item: two consumer warpgroups x 64
constexpr int kPN = 128;         // output columns of a chunk (the wgmma N)
constexpr int kPK = 64;          // depth of one TMA box of W: one 128-byte swizzle row
constexpr int kPStages = 3;      // ring stages
constexpr int kPThreads = 256;   // two consumer warpgroups (all registers theirs: no producer warp)
constexpr int kPRegTiles = 6;    // 64-deep tiles of a warpgroup's LN rows held in registers
constexpr int kPBox = kPN * 128;          // bytes of one W box (128 rows x 128 B)
constexpr int kPTile = 64 * 128;          // bytes of 64 rows x 128 B: an LN tile or a staged output box
constexpr size_t kSmemMax = 232448;       // shared memory a block may take on sm_90 (227 KB)

// The layout of the kernel at D = 64 DK. Up to D = 768 (DK <= 12): ring
// stages of two W boxes (128 deep), two staged output boxes a warpgroup, as
// many LN tiles a warpgroup as register tiles (the shared half, at most as
// many, takes their place once they are in registers). Past it (the wide
// layout, ViT-L's D = 1024): 128 rows x 1024 x 2 B of LN rows (256 KB) do
// not fit beside a ring, and the 6 register tiles leave DK - 6 = 10 shared
// tiles a warpgroup (160 KB), so the stages hold one W box (64 deep) and
// each warpgroup stages one output box at a time (231,488 bytes in all).
template <int DK>
struct ProjCfg {
  static constexpr bool kWide = DK > 12;
  static constexpr int kRegTiles = DK < kPRegTiles ? DK : kPRegTiles;
  static constexpr int kShTiles = DK - kRegTiles;
  static constexpr int kLnTiles = kRegTiles > kShTiles ? kRegTiles : kShTiles;
  static constexpr int kBoxes = kWide ? 1 : 2;     // W boxes a ring step
  static constexpr int kOutBoxes = kWide ? 1 : 2;  // staged output boxes a warpgroup
  // 8-column chunks a lane holds in the statistics pass (3 up to D = 768)
  static constexpr int kLnChunks = kWide ? (DK * 8 + 31) / 32 : 3;
  static constexpr int kStage = kBoxes * kPBox;
  // the W ring, the staged output boxes, each warpgroup's LN tiles, its
  // rows' mean and rstd, the full barriers and done counts, 1024-byte
  // alignment
  static constexpr size_t kSmem = (size_t)kPStages * kStage + 2 * kOutBoxes * kPTile +
                                  (size_t)2 * kLnTiles * kPTile + 2 * 64 * sizeof(float2) + 64 + 1024;
  static_assert(kSmem <= kSmemMax, "the projection's shared memory");
  static_assert(DK * 8 <= kLnChunks * 32, "the statistics pass holds a row");
};

// y = (v - mu) rstd gamma + beta of 8 columns, rounded to bf16, in one
// 16-byte store (the first port's expression)
__device__ __forceinline__ void ln_store8(unsigned char* dst, const float (&v)[8], float mu, float rstd,
                                          const float* gamma, const float* beta) {
  const float4 g0 = reinterpret_cast<const float4*>(gamma)[0], g1 = reinterpret_cast<const float4*>(gamma)[1];
  const float4 b0 = reinterpret_cast<const float4*>(beta)[0], b1 = reinterpret_cast<const float4*>(beta)[1];
  const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
  const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  uint32_t packed[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    packed[e] = pack_bf16((v[2 * e] - mu) * rstd * gm[2 * e] + bt[2 * e],
                          (v[2 * e + 1] - mu) * rstd * gm[2 * e + 1] + bt[2 * e + 1]);
  *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// Persistent: block i takes the items i, i + gridDim.x, ... of (128-row
// tile, column part), parts fastest; a part is cpp = nc / parts chunks of
// 128 columns. Warpgroup wg (0, 1) owns rows 64 wg .. + 63 of an item and
// multiplies them by every chunk of its part: the LN rows of its first
// min(DK, 6) 64-deep tiles are the register A operand of wgmma, the rest
// shared (128B-swizzled, 64 rows x 128 B a tile). The block's W steps (two
// 64-deep boxes of a chunk, 128 rows each; one box in the wide layout),
// item after item, stream through a ring of kPStages by TMA on per-stage
// mbarriers; the last of the 8 warps done with a stage refills it. DK = D /
// 64; ProjCfg<DK> is the layout.
template <int DK>
__global__ void __launch_bounds__(kPThreads, 1)
ln_qkv_proj_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const __grid_constant__ CUtensorMap tw,
                   const float* __restrict__ bias, const __grid_constant__ CUtensorMap tout, int m,
                   int n, int parts, float eps) {
  using Cfg = ProjCfg<DK>;
  constexpr int d = DK * kPK;
  constexpr int DR = Cfg::kRegTiles, DS = Cfg::kShTiles, LT = Cfg::kLnTiles;
  constexpr int NB = Cfg::kBoxes, OB = Cfg::kOutBoxes, LNC = Cfg::kLnChunks;
  constexpr int SPC = (DK + NB - 1) / NB;  // ring steps of a chunk
  constexpr int xvec = d / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = sm;                                  // [kPStages][NB boxes]
  unsigned char* outs = ring + kPStages * Cfg::kStage;       // [2 warpgroups][OB boxes]
  unsigned char* lns = outs + 2 * OB * kPTile;               // [2 warpgroups][LT tiles]
  float2* stats = reinterpret_cast<float2*>(lns + 2 * LT * kPTile);     // [2 warpgroups][64 rows]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 2 * 64);         // [kPStages]
  int* done = reinterpret_cast<int*>(full + kPStages);                  // [kPStages]

  const int tid = threadIdx.x;
  const int nc = (n + kPN - 1) / kPN, cpp = nc / parts;
  const int n_items = ((m + kPM - 1) / kPM) * parts, per_item = cpp * SPC;

  // ring step tt of the block (item blockIdx.x + (tt / per_item) gridDim.x,
  // chunk (tt / SPC) % cpp of its part, depth 64 NB (tt % SPC) ..) into its
  // stage by TMA, completing on the stage's full barrier; columns past n
  // land as zeros; nothing past the block's last item. One thread.
  auto load = [&](int tt) {
    const int it = blockIdx.x + (tt / per_item) * gridDim.x;
    if (it >= n_items) return;
    const int s = tt % SPC, st = tt % kPStages;
    const int col0 = ((it % parts) * cpp + (tt / SPC) % cpp) * kPN;
    const int kt0 = NB * s, boxes = kt0 + NB <= DK ? NB : DK - kt0;
    unsigned char* dst = ring + st * Cfg::kStage;
    mbar_expect_tx(&full[st], (uint32_t)(boxes * kPBox));
    for (int h = 0; h < boxes; ++h) tma_2d(dst + h * kPBox, &tw, (kt0 + h) * kPK, col0, &full[st]);
  };
  if (tid == 0) {
    for (int st = 0; st < kPStages; ++st) {
      mbar_init(&full[st], 1);
      done[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < kPStages; ++st) load(st);
  }
  __syncthreads();

  // warp-uniform as the compiler sees it (a shuffle of lane 0's value), so
  // the wgmma do not lie on a divergent path
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool issuer = (tid & 127) == 0;  // this warpgroup's TMA stores
  unsigned char* my_out = outs + wg * OB * kPTile;
  unsigned char* my_ln = lns + wg * LT * kPTile;
  float2* my_stats = stats + wg * 64;
  uint32_t a[DR * 4][4];  // LN rows r0, r1 as the A fragments of the register k-steps
  float acc[64];
  int tt = 0;  // ring steps this block has consumed

  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int rw = (it / parts) * kPM + wg * 64;  // this warpgroup's first row
    const int part = it % parts;

    // 1. LayerNorm statistics in fp32, a warp its 16 rows one at a time, a
    //    lane 8 columns at a time (two passes over the row in registers, the
    //    first port's order of operations; rows past m are zeros); y of the
    //    register tiles rounded to bf16 into the LN tiles in 16-byte stores
    //    (128B-swizzled), then into the A fragments by ldmatrix
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int rl = warp * 16 + i, gr = rw + rl;
      float v[LNC][8];
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < LNC; ++c) {
        const int cc = c * 32 + lane;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[c][e] = 0.f;
        if (cc < xvec && gr < m) load8(x + (size_t)gr * d + cc * 8, v[c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum += v[c][2 * e] + v[c][2 * e + 1];
      }
      const float mu = warp_sum(sum) / d;
      float var = 0.f;
#pragma unroll
      for (int c = 0; c < LNC; ++c) {
        if (c * 32 + lane < xvec) {
#pragma unroll
          for (int e = 0; e < 8; ++e) var += (v[c][e] - mu) * (v[c][e] - mu);
        }
      }
      const float rstd = rsqrtf(warp_sum(var) / d + eps);
#pragma unroll
      for (int c = 0; c < LNC; ++c) {
        const int cc = c * 32 + lane;
        if (cc < DR * 8) ln_store8(my_ln + (cc >> 3) * kPTile + sw128_offset(rl, cc & 7), v[c], mu, rstd, gamma + cc * 8, beta + cc * 8);
      }
      if (lane == 0) my_stats[rl] = make_float2(mu, rstd);
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");  // this warpgroup only
#pragma unroll
    for (int s = 0; s < DR * 4; ++s)
      ldmatrix_x4(a[s], my_ln + (s >> 2) * kPTile +
                            sw128_offset(warp * 16 + (lane & 15), (s & 3) * 2 + (lane >> 4)));
    // 2. y of the shared tiles (depth >= 64 DR) in their place, once every
    //    warp of the warpgroup has read the register tiles
    if constexpr (DS > 0) {
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const int rl = warp * 16 + i, gr = rw + rl;
        const float2 st = my_stats[rl];
#pragma unroll
        for (int c = 0; c < LNC; ++c) {
          const int cc = c * 32 + lane;
          if (cc >= DR * 8 && cc < xvec) {
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = 0.f;
            if (gr < m) load8(x + (size_t)gr * d + cc * 8, v);
            ln_store8(my_ln + ((cc >> 3) - DR) * kPTile + sw128_offset(rl, cc & 7), v, st.x, st.y,
                      gamma + cc * 8, beta + cc * 8);
          }
        }
      }
      fence_proxy_async();  // the shared LN tiles, for the wgmma's async proxy
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    }
    const int rl = warp * 16 + g;

    // 3. chunk by chunk: C[64 x 128] = Y . W[chunk]^T, ring step by step:
    //    step s is issued while step s - 1's products finish, then step s -
    //    1's stage is released (every wait on a barrier comes before the
    //    wgmma fence; the accumulators are read after the chunk's last wait)
    auto release = [&](int done_tt) {  // this warp is done with the stage; the last of the 8 refills it
      const int st = done_tt % kPStages;
      if (lane == 0 && atomicAdd(&done[st], 1) == 2 * 4 - 1) {
        done[st] = 0;
        load(done_tt + kPStages);
      }
    };
    for (int c = 0; c < cpp; ++c) {
#pragma unroll
      for (int s = 0; s < SPC; ++s, ++tt) {
        const int st = tt % kPStages;
        mbar_wait(&full[st], (tt / kPStages) & 1);
        const unsigned char* wb = ring + st * Cfg::kStage;
        wgmma_fence();
#pragma unroll
        for (int h = 0; h < NB; ++h) {
          const int kt = NB * s + h;
          if (kt < DK) {
#pragma unroll
            for (int kk = 0; kk < kPK / 16; ++kk) {
              const uint64_t db = sw128_desc(wb + h * kPBox + kk * 32);
              if (kt < DR)
                wgmma_m64n128k16_rs(acc, a[kt * 4 + kk], db, kt + kk > 0);
              else
                wgmma_m64n128k16(acc, sw128_desc(my_ln + (kt - DR) * kPTile + kk * 32), db, 1);
            }
          }
        }
        wgmma_commit();
        if (s > 0) {
          wgmma_wait<1>();
          release(tt - 1);
        }
      }
      wgmma_wait<0>();
      release(tt - 1);

      // epilogue: + fp32 bias, rounded to bf16, staged as 64 x 64 boxes
      // (128B-swizzled; both at once, or one after the other in the wide
      // layout) and written by TMA, rows past m and columns past n clipped;
      // the staged boxes are free once the previous store has read them
      const int col0 = (part * cpp + c) * kPN;
#pragma unroll
      for (int hb = 0; hb < 2; hb += OB) {
        if (issuer) bulk_wait_read<0>();
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
#pragma unroll
        for (int jb = 0; jb < 8 * OB; ++jb) {
          const int j = hb * 8 + jb;
          const int col = col0 + j * 8 + 2 * t4;
          const float b0 = col < n ? bias[col] : 0.f, b1 = col < n ? bias[col + 1] : 0.f;
          unsigned char* box = my_out + (jb >> 3) * kPTile;
          *reinterpret_cast<uint32_t*>(box + sw128_offset(rl, j & 7) + 4 * t4) =
              pack_bf16(acc[4 * j] + b0, acc[4 * j + 1] + b1);
          *reinterpret_cast<uint32_t*>(box + sw128_offset(rl + 8, j & 7) + 4 * t4) =
              pack_bf16(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
        }
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
        if (issuer && rw < m) {
#pragma unroll
          for (int q = 0; q < OB; ++q)
            if (col0 + 64 * (hb + q) < n)
              tma_store_2d(&tout, my_out + q * kPTile, col0 + 64 * (hb + q), rw);
          bulk_commit();
        }
      }
    }
  }
  if (issuer) bulk_wait_all();
}

// Column parts of an item: the divisor p of the nc chunks that minimizes
// the waves of items on the SMs times an item's chunks plus one for its
// LayerNorm (a window forward, 251 row tiles: 1; a training step's 29: 9).
int proj_parts(int row_items, int nc, int sms) {
  int best = 1;
  long long best_cost = -1;
  for (int p = 1; p <= nc; ++p) {
    if (nc % p) continue;
    const long long waves = ((long long)row_items * p + sms - 1) / sms;
    const long long cost = waves * (nc / p + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = p;
    }
  }
  return best;
}

template <int DK>
cudaError_t launch_proj_dk(const void* x, const void* gamma, const void* beta, const CUtensorMap& tw,
                           const void* bias, const CUtensorMap& tout, int m, float eps, cudaStream_t st) {
  const int n = 3 * DK * kPK;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const int row_items = (m + kPM - 1) / kPM, nc = (n + kPN - 1) / kPN;
  const int parts = proj_parts(row_items, nc, sms);
  const long long items = (long long)row_items * parts;
  const int blocks = (int)(items < sms ? items : sms);
  const size_t smem = ProjCfg<DK>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(ln_qkv_proj_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  ln_qkv_proj_kernel<DK><<<blocks, kPThreads, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta), tw,
      static_cast<const float*>(bias), tout, m, n, parts, eps);
  return cudaGetLastError();
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

// LNV: the float4 a lane holds for the LN statistics (6 up to D = 768, 8 up
// to kMaxDim)
template <int LNV>
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
    float4 v[LNV];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < LNV; ++c) {
      const int cc = c * 32 + lane;
      v[c] = gr < m && cc < xvec ? reinterpret_cast<const float4*>(x + (size_t)gr * d)[cc] : zero;
      sum += (v[c].x + v[c].y) + (v[c].z + v[c].w);
    }
    const float mu = warp_sum(sum) / d;
    float var = 0.f;
#pragma unroll
    for (int c = 0; c < LNV; ++c) {
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
  CUtensorMap tw, tout;
  cudaError_t e = encode_map(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, d, 3 * d, kPN);
  if (e == cudaSuccess) e = encode_map(&tout, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, qkv, 3 * d, m, 64);
  if (e != cudaSuccess) return e;
#define EBC_PROJ(DK_) launch_proj_dk<DK_>(x, gamma, beta, tw, bias, tout, m, eps, st)
  switch (d / kPK) {
    case 1: return EBC_PROJ(1);
    case 2: return EBC_PROJ(2);
    case 3: return EBC_PROJ(3);
    case 4: return EBC_PROJ(4);
    case 5: return EBC_PROJ(5);
    case 6: return EBC_PROJ(6);
    case 7: return EBC_PROJ(7);
    case 8: return EBC_PROJ(8);
    case 9: return EBC_PROJ(9);
    case 10: return EBC_PROJ(10);
    case 11: return EBC_PROJ(11);
    case 12: return EBC_PROJ(12);
    case 13: return EBC_PROJ(13);
    case 14: return EBC_PROJ(14);
    case 15: return EBC_PROJ(15);
    case 16: return EBC_PROJ(16);
    default: return cudaErrorInvalidValue;
  }
#undef EBC_PROJ
}

cudaError_t launch_proj_f32(const void* x, const void* gamma, const void* beta, const void* w,
                            const void* bias, void* qkv, int m, int d, float eps, cudaStream_t st) {
  const int n = 3 * d;
  const dim3 grid((n + kFN - 1) / kFN, (m + kFM - 1) / kFM);
  auto* kernel = d <= 768 ? ln_qkv_proj_f32_kernel<6> : ln_qkv_proj_f32_kernel<kMaxDim / 128>;
  kernel<<<grid, kFThreads, 0, st>>>(
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
