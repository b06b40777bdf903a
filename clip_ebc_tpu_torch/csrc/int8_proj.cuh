// LayerNorm -> static int8 quantize -> int8 x int8 -> int32 projection ->
// epilogue: the W8A8 half shared by the int8 kernels (csrc/fused_attention_int8.cu
// for the QKV projection, csrc/fused_mlp_int8.cu for the MLP's fc product).
// It ports the int8 branch of the Pallas bodies _ln_qkv_kernel and
// _ln_mlp_kernel (clip_ebc_tpu/ops/fused_attention.py).
//
// What it computes, rounding where the TPU kernels round: fp32 LayerNorm of
// x (M, D), not rounded to the activation dtype; yq = clip(round-half-even(y
// * inv_act), -127, 127) with inv_act = 1 / act_scale read from device memory
// (no host read of the calibrated scale); acc = yq . w_q^T in exact int32;
// v = acc * sw + bias in fp32 with multiply and add apart (sw = s_col *
// act_scale per output column, folded on the host side of the launch); then
// per epilogue:
//  * kEpiFloat: v rounded to the activation dtype (the qkv of the float
//    attention);
//  * kEpiInt8: clip(round(v)) as int8 (the qkv of the int8 attention: sw and
//    bias come with the 1 / (q, k, v scale) folded in, so v is already in the
//    int8 domain, as in the Pallas body's quant_attn="static" branch);
//  * kEpiGeluInt8: clip(round(gelu(v) * inv_out)) as int8 (the MLP hidden,
//    quantized at the calibrated scale of the GELU output; QuickGELU or the
//    tanh GELU of _ln_mlp_kernel, each operation rounded on its own).
//
// Bound at the QKV projection of a window forward (M = 140 x 229 = 32,060
// rows, D = 768, N = 2304; H100 SXM, 700 W): 113.5 GOP of int8 over 1,979
// TOP/s = 0.057 ms, against x in, the output and W: 125 MB with an int8
// output (0.037 ms at 3.35 TB/s), 199 MB with bf16 (0.059 ms), 396 MB with
// fp32 x and output (0.118 ms). Operations and bytes are even, so the design
// overlaps the product, the output stores and the LayerNorm's loads.
//
// Design (wgmma, TMA, sm_90a; redesigned after the first port, one block of
// 8 warps per 128 rows with mma.sync.m16n8k32 fed by ldmatrix from a
// 4-stage cp.async ring with a block-wide barrier per W tile and the
// epilogue in series with the products: 0.372 ms at the shape above, 1.8x
// cuBLAS's bare int8 product):
//  * a persistent block on each SM walks the 128-row items; two
//    warpgroups own 64 rows each.
//  * the LayerNorm: each warp takes the statistics of its 16 rows as the
//    first port did (a row in registers, 8 columns a lane at a time, two
//    passes, the same order of operations), then normalizes and quantizes
//    its rows straight into the register A fragments of wgmma (16 rows x
//    32 values a k-step, 4 bytes a register): up to D = 768 the yq of all
//    D columns stay in registers (D / 8 a thread), so no quantized row
//    touches shared memory and the ring takes it all (past it, see below).
//  * W, read in torch's (out, in) layout, is the K-major B operand as it
//    stands (8-bit wgmma takes both operands K-major only). It comes by
//    TMA in chunks of 64 output columns x D (boxes of 64 rows x
//    128 bytes, 128B-swizzled, the layout sw128_desc names) into a ring of
//    chunk stages on per-stage mbarriers; the second warpgroup done with a
//    stage refills it, so no producer warp takes registers (with one, ptxas
//    held every thread to 168 and the kernel spilled).
//  * products: wgmma m64n64k32.s32.s8.s8, A from registers, B from the
//    ring, D / 32 of them a chunk into 32 int32 accumulators a thread. The
//    two warpgroups take turns to issue a chunk's products (the ping-pong
//    schedule of CUTLASS), so one's epilogue and stores run under the
//    other's tensor work (the first port's ran in series). Double-buffered
//    accumulators in one warpgroup (the next chunk's products issued before
//    this one's epilogue) were tried first: ptxas (C7514) serializes every
//    wgmma when accumulators are read while another group is in flight
//    across loop iterations.
//  * epilogue: dequantize (multiply and add apart; the chunk's sw and bias
//    land by bulk copy with its W), the epilogue's rounding, then 16- and
//    8-bit outputs staged in a swizzled tile per warpgroup and written in
//    16-byte stores, fp32 pairs stored from the accumulators.
//  * where the time goes (timing-only copies with parts removed, PERF.md):
//    without any wgmma the kernel keeps two thirds of its time, so a
//    warpgroup's epilogue outlasts the other's 24 products and the tensor
//    time adds to it instead of hiding under it. Tried and dropped, each
//    slower on an H100: chunks of 128 columns (two ring stages, spills), W
//    multicast by TMA to clusters of two blocks (half the L2 reads, but
//    each stage waits on both blocks), bf16 pairs stored from the
//    accumulators without staging.
//  * fp32 activations (a model run without --amp) take the same int8
//    product; only the loads of x and the float stores differ.
//  * past D = 768 (ViT-L, D = 1024: 4 more A fragments a k-box, 128
//    registers a thread for all of A, which will not fit beside the
//    accumulators and the epilogue) the first kQRegK = 6 k-boxes (768
//    columns) stay in registers as above and the rest go to shared memory,
//    each warpgroup's 64 rows x 128 bytes a box in the 128B-swizzled
//    K-major layout, fed to wgmma as the A descriptor (the SS form). At D =
//    1024 that is 32 KB beside a ring of 64 KB chunks: 2 stages (3 with
//    fp32 outputs, which stage nothing), the fewest the ping-pong needs
//    (a warpgroup's next chunk must have landed while the other still
//    reads this one). D <= 768 is the same template with no shared A.
//
// Limits: D a multiple of 128, D <= 1024 (the quantized rows held in
// registers, the k-boxes past 6 in shared memory; a lane holds a row's
// 8-column chunks in the statistics pass); N a multiple of 128.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ebc {

constexpr int kQM = 128;         // rows of an item: two consumer warpgroups x 64
constexpr int kQN = 64;          // output columns of a chunk (the wgmma N)
constexpr int kQAcc = kQN / 2;   // int32 accumulators a thread
constexpr int kQK = 128;         // depth (bytes) of one TMA box of W: one 128-byte swizzle row
constexpr int kQThreads = 2 * 128;  // two warpgroups (all 255 registers a thread: no producer warp)
constexpr int kQLnChunks = 3;    // 8-column chunks a lane holds in the statistics pass (D <= 768)
constexpr int kQRegK = 6;        // k-boxes of A held in registers; the rest in shared memory
constexpr int kQMaxDim = 1024;
constexpr int kQMaxStages = 4;
constexpr int kQABox = 64 * kQK;  // bytes of a warpgroup's shared A box: 64 rows x 128 bytes
constexpr int kQColBytes = 2 * kQN * 4;  // a stage's sw and bias of its kQN columns
constexpr size_t kQSmemBudget = 227 * 1024 - 1024 - kQMaxStages * 12;

enum { kEpiFloat = 0, kEpiInt8 = 1, kEpiGeluInt8 = 2 };

// Bytes of one warpgroup's staged output tile (64 rows x kQN columns): 16-
// and 8-bit outputs are staged for 16-byte stores; fp32 pairs go straight
// out (a quad's 8-byte stores fill a 32-byte sector of a row).
template <typename TOut>
__host__ __device__ constexpr int qout_tile_bytes() { return sizeof(TOut) < 4 ? 64 * kQN * (int)sizeof(TOut) : 0; }
// Bytes of a ring stage: a W chunk of kQN columns x D (its sw and bias
// beside it in a small ring of their own).
template <int DK>
__host__ __device__ constexpr int qstage_bytes() { return kQN * kQK * DK; }
// Bytes of both warpgroups' A boxes in shared memory (the k-boxes past kQRegK)
template <int DK>
__host__ __device__ constexpr int qshared_a_bytes() { return DK > kQRegK ? 2 * (DK - kQRegK) * kQABox : 0; }
// Stages in the ring beside the shared A boxes and the staged outputs (one a warpgroup)
template <int DK, typename TOut>
__host__ __device__ constexpr int qproj_stages() {
  return (int)((kQSmemBudget - qshared_a_bytes<DK>() - 2 * qout_tile_bytes<TOut>()) /
               (qstage_bytes<DK>() + kQColBytes)) < kQMaxStages
             ? (int)((kQSmemBudget - qshared_a_bytes<DK>() - 2 * qout_tile_bytes<TOut>()) /
                     (qstage_bytes<DK>() + kQColBytes))
             : kQMaxStages;
}
template <int DK, typename TOut>
constexpr size_t qproj_smem_bytes() {
  return (size_t)qproj_stages<DK, TOut>() * (qstage_bytes<DK>() + kQColBytes) + qshared_a_bytes<DK>() +
         2 * qout_tile_bytes<TOut>() + kQMaxStages * 12 + 1024;
}

// c (16x8 int32) += a (16x32 int8, row-major) . b (32x8 int8, column-major).
// Lane (g = lane / 4, t = lane % 4) holds a = {(g, 4t..4t+3), (g+8, 4t..),
// (g, 16+4t..), (g+8, 16+4t..)}, b = {(4t..4t+3, g), (16+4t.., g)} and
// c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}; within a register the
// lowest byte holds the lowest k.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (64 x 64 int32 over the warpgroup's 128 threads, 32 a thread, in the
// layout of wgmma_m64n128k16's d) (+)= A (64 x 32 int8 in registers: warp w's
// 16 rows in the mma_s8 A layout) . B (32 x 64 int8, K-major in shared
// memory, 128B-swizzled rows of 128 bytes).
__device__ __forceinline__ void wgmma_s8_m64n64k32_rs(int (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// The same with A (64 x 32 int8) K-major in shared memory (128B-swizzled
// rows of 128 bytes).
__device__ __forceinline__ void wgmma_s8_m64n64k32_ss(int (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128 int32, 64 a thread in the layout of wgmma_m64n128k16's d)
// (+)= A (64 x 32 int8) . B (32 x 128 int8), both K-major in shared memory.
__device__ __forceinline__ void wgmma_s8_m64n128k32(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// The same with B 32 x 192 (d 64 x 192 int32, 96 a thread).
__device__ __forceinline__ void wgmma_s8_m64n192k32(int (&d)[96], uint64_t desc_a, uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// 4 consecutive values of a row as floats.
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Two consecutive values of a row as floats.
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// round-half-even to int, clipped to the symmetric int8 range
__device__ __forceinline__ int clip8(float v) { return max(-127, min(127, __float2int_rn(v))); }

__device__ __forceinline__ int quant8(float y, float inv_act) { return clip8(__fmul_rn(y, inv_act)); }

// QuickGELU h * sigmoid(1.702 h), or the tanh GELU 0.5 h (1 + tanh(c (h +
// 0.044715 h^3))), every operation rounded on its own as the plain version
// (one PyTorch operation each) rounds.
__device__ __forceinline__ float gelu(float h, int quick) {
  if (quick) return __fmul_rn(h, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(1.702f, h)))));
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, h), h), h);
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, tanhf(__fmul_rn(c, __fadd_rn(h, cube)))));
}

// The LN output y = ((v - mu) rstd) gamma + beta, each operation rounded on
// its own, quantized; four of them packed, the first lowest.
__device__ __forceinline__ uint32_t ln_quant4(float4 v, float mu, float rstd, float4 ga, float4 be,
                                              float inv_act) {
  const float vv[4] = {v.x, v.y, v.z, v.w}, gg[4] = {ga.x, ga.y, ga.z, ga.w},
              bb[4] = {be.x, be.y, be.z, be.w};
  uint32_t packed = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float y = __fadd_rn(__fmul_rn(__fmul_rn(vv[e] - mu, rstd), gg[e]), bb[e]);
    packed |= (uint32_t)(quant8(y, inv_act) & 0xff) << (8 * e);
  }
  return packed;
}

// A staged output tile holds 64 rows of P 16-byte pieces; piece c of row r
// lies at c ^ (r % 8) (P = 8, 16) or c ^ ((r / 2) % 4) (P = 4), so that a
// warp's fragment writes spread over the banks.

// The output pair at ``p`` in the staged tile, with the epilogue's rounding.
template <typename TOut, int Epi>
__device__ __forceinline__ void stage_pair(unsigned char* p, float a, float b, float inv_out, int quick) {
  if constexpr (Epi == kEpiFloat) {
    store2(reinterpret_cast<TOut*>(p), a, b);
  } else {
    int qa, qb;
    if constexpr (Epi == kEpiInt8) {
      qa = clip8(a);
      qb = clip8(b);
    } else {
      qa = quant8(gelu(a, quick), inv_out);
      qb = quant8(gelu(b, quick), inv_out);
    }
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)((qa & 0xff) | ((qb & 0xff) << 8));
  }
}

// Persistent: block i takes the 128-row items i, i + gridDim.x, ...;
// warpgroup wg (0, 1) owns rows 64 wg .. + 63 of each. The block's W chunks,
// item after item, stream through the ring: the second warpgroup done with
// a stage refills it with the chunk kStages on (no producer warp, so the
// two warpgroups keep all 255 registers a thread). DK = D / 128 (the A
// fragments are registers, so their count is a template); k-boxes past
// kQRegK are A boxes in shared memory.
template <typename T, int Epi, int DK>
__global__ void __launch_bounds__(kQThreads, 1)
ln_proj_int8_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const __grid_constant__ CUtensorMap tw,
                    const float* __restrict__ sw, const float* __restrict__ bias,
                    const float* __restrict__ inv_act_ptr, void* __restrict__ out, int m, int n,
                    float eps, const float* __restrict__ inv_out_ptr, int quick) {
  using TOut = std::conditional_t<Epi == kEpiFloat, T, int8_t>;
  constexpr int d = DK * kQK;
  constexpr int RK = DK < kQRegK ? DK : kQRegK;     // k-boxes of A in registers
  constexpr int SK = DK - RK;                       // and in shared memory
  constexpr int LC = DK > kQRegK ? 4 : kQLnChunks;  // 8-column chunks a lane holds of a row
  constexpr int kStages = qproj_stages<DK, TOut>();
  static_assert(kStages >= 2, "the ping-pong needs a chunk in flight beside the one read");
  constexpr int kChunk = kQN * d;                 // bytes of a W chunk: DK boxes of kQN rows x 128 B
  constexpr int kStage = qstage_bytes<DK>();
  constexpr int kTile = qout_tile_bytes<TOut>();  // one staged output tile
  constexpr int P = kQN * (int)sizeof(TOut) / 16; // 16-byte chunks of a staged row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = sm;                                           // [kStages][kStage]
  unsigned char* sha = ring + kStages * kStage;                       // [2 warpgroups][SK][kQABox]
  unsigned char* tiles = sha + qshared_a_bytes<DK>();                 // [2 warpgroups][kTile]
  float* cols = reinterpret_cast<float*>(tiles + 2 * kTile);          // [kStages][sw, bias][kQN]
  uint64_t* full = reinterpret_cast<uint64_t*>(cols + kStages * 2 * kQN);  // [kStages]
  int* done = reinterpret_cast<int*>(full + kStages);                 // [kStages]

  const int tid = threadIdx.x;
  const int nc = n / kQN, n_items = (m + kQM - 1) / kQM;
  // chunk tt of the block (item blockIdx.x + (tt / nc) gridDim.x, columns
  // kQN (tt % nc) ..) into its stage, W by TMA and its columns' sw and bias
  // by bulk copy, completing on the stage's full barrier; nothing past the
  // block's last item. One thread.
  auto load = [&](int tt) {
    const int it = blockIdx.x + (tt / nc) * gridDim.x, st = tt % kStages, col0 = (tt % nc) * kQN;
    if (it >= n_items) return;
    unsigned char* dst = ring + st * kStage;
    mbar_expect_tx(&full[st], (uint32_t)(kChunk + kQColBytes));
    for (int kb = 0; kb < DK; ++kb) tma_2d(dst + kb * kQN * kQK, &tw, kb * kQK, col0, &full[st]);
    bulk_copy(cols + st * 2 * kQN, sw + col0, kQN * sizeof(float), &full[st]);
    bulk_copy(cols + st * 2 * kQN + kQN, bias + col0, kQN * sizeof(float), &full[st]);
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      done[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < kStages; ++st) load(st);
  }
  __syncthreads();

  // warp-uniform as the compiler sees it (a shuffle of lane 0's value), so
  // the wgmma do not lie on a divergent path
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float inv_act = *inv_act_ptr;
  const float inv_out = Epi == kEpiGeluInt8 ? *inv_out_ptr : 0.f;
  unsigned char* my_tile = tiles + wg * kTile;
  constexpr int xvec = d / 8;
  uint32_t a[RK * 4][4];  // yq of rows r0, r1 as the A fragments of the first RK * 4 k-steps
  unsigned char* my_a = sha + wg * SK * kQABox;  // this warpgroup's A boxes past RK
  int acc[kQAcc];
#pragma unroll
  for (int i = 0; i < kQAcc; ++i) acc[i] = 0;
  if (wg == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");  // warpgroup 0 issues first

  // chunk number tt of the block into acc (D / 32 wgmma, committed as one
  // group); the wait on its stage precedes the fence
  auto issue = [&](int (&acc)[kQAcc], int tt) {
    const int st = tt % kStages;
    mbar_wait(&full[st], (tt / kStages) & 1);
    const unsigned char* wb = ring + st * kStage;
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < RK; ++kb)
#pragma unroll
      for (int kk = 0; kk < kQK / 32; ++kk)
        wgmma_s8_m64n64k32_rs(acc, a[kb * 4 + kk], sw128_desc(wb + kb * kQN * kQK + kk * 32),
                              kb + kk > 0);
#pragma unroll
    for (int kb = RK; kb < DK; ++kb)
#pragma unroll
      for (int kk = 0; kk < kQK / 32; ++kk)
        wgmma_s8_m64n64k32_ss(acc, sw128_desc(my_a + (kb - RK) * kQABox + kk * 32),
                              sw128_desc(wb + kb * kQN * kQK + kk * 32), 1);
    wgmma_commit();
  };

  int t = 0;  // chunks this block has consumed
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int rw = it * kQM + wg * 64;  // this warpgroup's first row

    // 1. LayerNorm statistics in fp32, a warp its 16 rows one at a time, a
    //    lane 8 columns at a time (two passes over the row in registers)
    float mu0 = 0.f, rs0 = 0.f, mu1 = 0.f, rs1 = 0.f;
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int gr = rw + warp * 16 + i;
      float v[LC][8];
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < LC; ++c) {
        const int cc = c * 32 + lane;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[c][e] = 0.f;
        if (cc < xvec && gr < m) load8(x + (size_t)gr * d + cc * 8, v[c]);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += v[c][e];
      }
      const float mu = warp_sum(sum) / d;
      float var = 0.f;
#pragma unroll
      for (int c = 0; c < LC; ++c) {
        if (c * 32 + lane < xvec) {
#pragma unroll
          for (int e = 0; e < 8; ++e) var += (v[c][e] - mu) * (v[c][e] - mu);
        }
      }
      const float rstd = rsqrtf(warp_sum(var) / d + eps);
      if ((i & 7) == g) {
        if (i < 8) {
          mu0 = mu;
          rs0 = rstd;
        } else {
          mu1 = mu;
          rs1 = rstd;
        }
      }
    }

    // 2. normalize and quantize this thread's A fragments: rows r0 and r1
    //    = r0 + 8, columns 32 s + 4 t4 .. + 3 and 32 s + 16 + 4 t4 .. + 3 of
    //    k-step s (rows past m: zeros, as the first port's LayerNorm saw);
    //    past k-box RK the same four bytes go to the warpgroup's shared A
    //    box instead (16-byte piece 2 (s % 4) + h of rows warp 16 + g and +
    //    8, which share one swizzle)
    const int r0 = rw + warp * 16 + g, r1 = r0 + 8;
    const T* x0 = x + (size_t)(r0 < m ? r0 : 0) * d;
    const T* x1 = x + (size_t)(r1 < m ? r1 : 0) * d;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < DK * 4; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 32 * s + 16 * h + 4 * t4;
        const float4 ga = *reinterpret_cast<const float4*>(gamma + col);
        const float4 be = *reinterpret_cast<const float4*>(beta + col);
        const uint32_t q0 = ln_quant4(r0 < m ? load4(x0 + col) : zero, mu0, rs0, ga, be, inv_act);
        const uint32_t q1 = ln_quant4(r1 < m ? load4(x1 + col) : zero, mu1, rs1, ga, be, inv_act);
        if (s < RK * 4) {
          a[s < RK * 4 ? s : 0][2 * h] = q0;
          a[s < RK * 4 ? s : 0][2 * h + 1] = q1;
        } else {
          unsigned char* p = my_a + (s / 4 - RK) * kQABox + sw128_offset(warp * 16 + g, 2 * (s % 4) + h) + 4 * t4;
          *reinterpret_cast<uint32_t*>(p) = q0;
          *reinterpret_cast<uint32_t*>(p + 8 * 128) = q1;
        }
      }
    if constexpr (SK > 0) {
      fence_proxy_async();  // the shared A boxes, for wgmma's async proxy
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");  // this warpgroup only
    }

    // 3. chunk by chunk (block chunk number t), the two warpgroups taking
    //    turns to issue their products (named barriers 3 and 4), so that one
    //    warpgroup's epilogue runs while the other's products are on the
    //    tensor cores. A warpgroup's turn barrier also tells it that all its
    //    warps are done with the previous chunk (its products, its sw and
    //    bias, the reads of the staged tile): that chunk's stage is released
    //    there, and the second warpgroup to release it refills it.
    //    The epilogue's addresses are this thread's constants: its staged
    //    rows rl and rl + 8 share one swizzle, and it copies 16-byte piece
    //    cc of rows ro + (128 / P) i out.
    const int rl = warp * 16 + g, ro = (tid & 127) / P, cc = (tid & 127) % P;
    const int swz = P == 4 ? (g >> 1) & 3 : g & 7, swz_o = P == 4 ? (ro >> 1) & 3 : ro & 7;
    const int sb = rl * (P * 16) + (int)sizeof(TOut) * 2 * t4;  // staged row rl, this thread's pair
    const int rb = ro * (P * 16) + ((cc ^ swz_o) << 4);           // staged piece read back
    unsigned char* ob = static_cast<unsigned char*>(out) + ((size_t)(rw + ro) * n) * sizeof(TOut) + cc * 16;
    for (int c = 0; c < nc; ++c, ++t) {
      asm volatile("bar.sync %0, 256;\n" :: "r"(3 + wg) : "memory");  // this warpgroup's turn
      if (t > 0 && (tid & 127) == 0 && atomicAdd(&done[(t - 1) % kStages], 1) == 1) {
        done[(t - 1) % kStages] = 0;
        load(t - 1 + kStages);
      }
      issue(acc, t);
      asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - wg) : "memory");  // the other's turn
      wgmma_wait<0>();

      // epilogue: dequantize (multiply and add apart), round, stage or store
      const int col0 = c * kQN;
      const float* cs = cols + (t % kStages) * 2 * kQN;
#pragma unroll
      for (int j = 0; j < kQN / 8; ++j) {
        const int col = j * 8 + 2 * t4;
        const float2 sv = *reinterpret_cast<const float2*>(cs + col);
        const float2 bv = *reinterpret_cast<const float2*>(cs + kQN + col);
        const int cb = (int)sizeof(TOut) * 8 * j;  // byte of column 8 j in a staged row
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float v0 = __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * hh], sv.x), bv.x);
          const float v1 = __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * hh + 1], sv.y), bv.y);
          if constexpr (kTile == 0) {
            const int gr = rw + rl + 8 * hh;
            if (gr < m) store2(static_cast<TOut*>(out) + (size_t)gr * n + col0 + col, v0, v1);
          } else {
            stage_pair<TOut, Epi>(my_tile + sb + hh * 8 * P * 16 + (((cb >> 4) ^ swz) << 4) + (cb & 15), v0,
                                  v1, inv_out, quick);
          }
        }
      }
      if constexpr (kTile > 0) {
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");  // this warpgroup only
#pragma unroll
        for (int i = 0; i < P / 2; ++i)
          if (rw + ro + (128 / P) * i < m)
            *reinterpret_cast<uint4*>(ob + ((size_t)(128 / P) * i * n + col0) * sizeof(TOut)) =
                *reinterpret_cast<const uint4*>(my_tile + rb + i * 2048);
      }
    }
  }
  if (wg == 0) asm volatile("bar.sync 3, 256;\n" ::: "memory");  // the last turn passed to it
}

template <typename T, int Epi, int DK>
cudaError_t launch_ln_proj_int8_dk(const void* x, const void* gamma, const void* beta,
                                   const CUtensorMap& tw, const void* sw, const void* bias,
                                   const void* inv_act, void* out, int m, int n, float eps,
                                   const void* inv_out, int quick, int blocks, cudaStream_t st) {
  using TOut = std::conditional_t<Epi == kEpiFloat, T, int8_t>;
  const size_t smem = qproj_smem_bytes<DK, TOut>();
  cudaError_t e = cudaFuncSetAttribute(ln_proj_int8_kernel<T, Epi, DK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  ln_proj_int8_kernel<T, Epi, DK><<<blocks, kQThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta), tw,
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<const float*>(inv_act), out, m, n, eps, static_cast<const float*>(inv_out), quick);
  return cudaGetLastError();
}

// One launch of ln_proj_int8_kernel: x (M, D) in T, gamma / beta (D,), w (N,
// D) int8, sw / bias (N,), inv_act one float on the device; out (M, N) in T
// (kEpiFloat) or int8; inv_out one float on the device (kEpiGeluInt8 only).
template <typename T, int Epi>
cudaError_t launch_ln_proj_int8(const void* x, const void* gamma, const void* beta, const void* w,
                                const void* sw, const void* bias, const void* inv_act, void* out,
                                int m, int d, int n, float eps, const void* inv_out, int quick,
                                cudaStream_t st) {
  CUtensorMap tw;
  // W (N, D) in torch's (out, in) layout: boxes of kQN rows x kQK bytes
  cudaError_t e = encode_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, d, n, kQN);
  if (e != cudaSuccess) return e;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const int items = (m + kQM - 1) / kQM, blocks = items < sms ? items : sms;
#define EBC_QPROJ(DK_) \
  launch_ln_proj_int8_dk<T, Epi, DK_>(x, gamma, beta, tw, sw, bias, inv_act, out, m, n, eps, inv_out, quick, blocks, st)
  switch (d / kQK) {
    case 1: return EBC_QPROJ(1);
    case 2: return EBC_QPROJ(2);
    case 3: return EBC_QPROJ(3);
    case 4: return EBC_QPROJ(4);
    case 5: return EBC_QPROJ(5);
    case 6: return EBC_QPROJ(6);
    case 7: return EBC_QPROJ(7);
    case 8: return EBC_QPROJ(8);
    default: return cudaErrorInvalidValue;
  }
#undef EBC_QPROJ
}

inline bool qproj_shape_ok(int m, int d, int n) {
  return m >= 1 && d >= kQK && d % kQK == 0 && d <= kQMaxDim && n >= 128 && n % 128 == 0;
}

}  // namespace ebc
