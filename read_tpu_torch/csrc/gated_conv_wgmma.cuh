// K2 for Hopper: a persistent, warp-specialized wgmma tile loop fed by an
// mbarrier ring of staged tiles (`gated_conv_kxk_wgmma`, gated_conv.cu),
// in three operand modes, with two producers.
//
// Replaces read_tpu/ops/gated_conv_pack.py `_conv3x3_chw_dot3_kernel`
// (:190, pallas_call :392) and the strided transitions read_tpu/models/
// unet_pallas.py `_Ctx.conv` routes through space-to-depth or im2col
// (:178-219). It takes the calls with Cin % 32 == 0, Cout % 8 == 0, a
// 16-byte aligned x and 8-byte aligned bias, scale, offset and residual
// (the epilogue reads channel pairs), in either operand mode; the rest
// (the 8-channel descriptor inputs, the Cout = 3 heads, misaligned views)
// keep the tile loops of gated_conv_tile.cuh. Python routes
// (ops/gated_conv.py `kxk_route`). It also takes K7 3x3, scripts/
// gated_conv_pallas_r2.py `_conv3x3_kernel` (:73, pallas_call :138): the
// same gated conv of one image (B = 1, stride 1, no residual), with x, w
// and the output all f32 or all bf16 (ops/gated_conv_r2.py `r2_route`).
//
// Three modes, two kernels:
// - bf16 (JAX's `mxu_bf16`; `wgmma_kernel`): the producer rounds the
//   input to bf16 (RNE, as torch's .to(bfloat16)) and one `wgmma m64nNk16
//   .bf16` product a k16 step sums in f32. A K slice is 64 channels (one
//   128-byte row).
// - bf16 storage (`wgmma_kernel`, BF16_IO; K7's bf16 contract): x and the
//   output are bf16 in memory. The producer stores each 16-byte chunk (8
//   channels) into the swizzled A stage as it was loaded, with no
//   conversion; the products are the bf16 mode's; the epilogue computes in
//   f32, rounds each channel pair once (RNE) and stores it as one
//   __nv_bfloat162. No residual. A plain load and shared store, as in the
//   bf16 mode: `cp.async` copies, each stage handed over once the next
//   one's were in flight, gave no consistent gain over the bench levels
//   (slower at 32 channels; PERF.md), and that hand-over deadlocks a
//   2-stage ring whose consumer keeps one stage in flight (the 1x1 loop's).
// - f32 (`wgmma_tf32_kernel`): three TF32 products, as the 1x1 loop's f32
//   mode (gated_conv_1x1_wgmma.cuh): each operand v is split as hi =
//   rna_tf32(v), lo = rna_tf32(v - hi) (`split_tf32`), and three `wgmma
//   m64nNk8 .tf32` products a k8 step sum hi*hi + hi*lo + lo*hi into one
//   f32 sum. Not exact f32 FMA, but held to the f32 bound (atol 2e-5, rtol
//   1e-4) against the plain f32 twin up to K = 16 * 256. A K slice is 32
//   channels of one tap (one 128-byte f32 row; Cin % 32 == 0, so no slice
//   straddles two taps). The tensor cores' own f32 accumulation drifted
//   past that bound over K >= 1024, so each slice's products start a fresh
//   wgmma sum, added into f32 registers (IEEE adds) once its group has
//   retired.
//
// What bounds it: at the 32-channel full-resolution layer (368x1216) the
// f32 activations read and written (0.034 ms at 3.35 TB/s against 0.017 ms
// of bf16 tensor-core work); at the deeper levels the tensor-core
// operations (0.017 ms a 3x3 layer in bf16, 6x that as three TF32
// products). The bf16 mode runs at 5-7x that (PERF.md), with the tensor
// cores mostly idle: fewer barrier arrivals changed nothing, and more
// registers a thread (one block per SM instead of two) made it slower,
// so the number of stages each SM keeps in flight sets its pace; K8's
// modes (below) put it in the thread producer's staging. The f32 mode ran
// at ~3.4x its TF32 bound with such a producer (loads, hi/lo split and 16
// KB of shared stores a slice, one slice in flight per SM), staging alone
// taking 0.77-0.80 of the loop. With A copied raw by TMA, 64-pixel tiles
// then ran at the L2's rate (6-7 TB/s of weight and patch blocks: the hi
// and lo weights, 32 KB a slice at 128 columns, for 8 KB of A), so two
// consumer warpgroups share each stage; the consumers now set the pace
// (K8 nopack within 0.87-0.97 of full): the products, each slice's
// `wait_group 0` before the promotion, the fragments' reads and splits
// (PERF.md section 6 gives each K8 mode's time at the four bench levels).
//
// Design. A channels-last implicit GEMM: M = output pixels, N = the
// layer's f|m columns, K = k*k*Cin tap-major, in slices of one 128-byte
// row (bf16: two taps of 32 channels at Cin = 32, one tap's 64 channels
// otherwise; f32: 32 channels of one tap).
// - Weights: `pack_kxk_bf16` / `pack_kxk_tf32` (ops/gated_conv.py) pack
//   them once per module into blocks of [TILE_N rows (n), 128 bytes (k)]
//   (f32: an hi block, then a lo block), one contiguous run per (N tile,
//   K slice), already in the 128-byte swizzle the wgmma descriptor reads,
//   with f and m columns interleaved in groups of 8 ([f c0..7 | m c0..7 |
//   f c8..15 | ...]). One `cp.async.bulk` per stage brings it in.
// - bf16 producer warpgroup (the block's last 128 threads): per slice,
//   waits for the stage to be empty, has one thread post the weight
//   block's byte count and issue its bulk copy, then all 128 load the
//   input patch as 16-byte vectors (zero outside the image, past K and past
//   the last pixel; stride and k = 4 by index arithmetic), convert them
//   (bf16 RNE) or not (bf16 storage) and store the swizzled A part;
//   `fence.proxy.async.shared::cta` makes those generic stores visible to
//   wgmma before each thread's arrive on the stage's full barrier (129
//   arrivals: 128 threads + the byte-count arrive).
// - f32 producer (one thread of the last warpgroup): per slice, waits for
//   the stage to be empty, posts the stage's bytes (16 KB of A + the weight
//   block) and issues two asynchronous copies that complete on the full
//   barrier (one arrival): the weight block's `cp.async.bulk`, and the raw
//   f32 patch, 128 pixels x 32 channels of one tap, by one TMA im2col load
//   (`cp.async.bulk.tensor.4d ... .im2col`) through a tensor map of x
//   encoded on the host per call (`encode_im2col`; the driver's encoder is
//   found through cudaGetDriverEntryPoint, so the library links only
//   cudart): NHWC dims, a bounding box from -pad to pad - (k - 1) past each
//   edge, traversal stride = the conv's stride (k3s2, k4s2), the tap as
//   the im2col offsets, the 128-byte swizzle, and out-of-bounds zero fill
//   for the padding and past the last pixel. ops/gated_conv.py
//   `im2col_copy_params` computes the same parameters, and its CPU tests
//   hold the walk they define against im2col at every routed call of a
//   full-width frame. No loads into registers, no conversion and no
//   generic shared-memory stores of A.
// - bf16 consumer warpgroup (the block's first 128 threads, 64 pixels):
//   waits for the full barrier, issues 4 `wgmma.mma_async` from shared
//   memory, commits, keeps that group in flight (`wait_group 1`) and frees
//   the previous stage (one arrive per warp on its empty barrier).
// - f32 consumer warpgroups (the block's first 256 threads, 64 pixels
//   each, one weight block shared): per k8 step each reads its A fragment
//   (rows 16 warp + lane/4 and + 8, columns lane % 4 and + 4;
//   conflict-free through the swizzle) from the raw stage into registers,
//   splits it there (`split_tf32`) and issues the three products in the
//   register-A form (`wgmma ... .tf32` with {a0..a3}, B from the packed
//   hi/lo blocks); the next step's fragment is read and split while the
//   products run. The slice's group retires (`wait_group 0`), the stage is
//   freed (the 8 consumer warps arrive) and the fresh sum is added into
//   the f32 accumulator. At 128 columns the producer warpgroup gives up
//   registers (`setmaxnreg` 40) and the consumers take them (232): two
//   accumulator sets and a slice's hi/lo fragments, no spill.
// - Epilogue from the accumulator registers: with f and m interleaved by
//   8 columns, a thread's fragments d[8q + 2h + e] and d[8q + 4 + 2h + e]
//   are f and m of the same (pixel, channel), so bias, ELU(f)*sigmoid(m),
//   the BN affine and the residual are applied in registers and stored as
//   8-byte pairs; no shared-memory round trip.
// - Persistent blocks: as many as fit on the card at once, each walking
//   tiles t, t + gridDim.x, ... through one ring, so no block waits to
//   start and one tile's epilogue overlaps the next tile's staging.
// K8's phase probe (template argument PROBE; C entry gated_conv_probe.cu)
// runs this loop with one phase stripped, in the bf16 and TF32 x3 modes;
// PROBE = kProduction (the default) is the kernel above, unchanged:
// - kProbeFull: the ring and the products as they are; `raw_epilogue`
//   stores the sums with no bias, gate or BN (out [.., 2*Cout]: f in
//   columns c, m in Cout + c);
// - kProbeNoPack: no A staging (bf16: the producer skips the patch loads
//   and the A stores but still posts the weight bytes, copies, fences and
//   arrives; f32: no A copy is issued, the weight copy and the barriers
//   stay), so the products run over stale shared memory: timing only;
// - kProbePackOnly: the producer as in full; the consumer issues no
//   product and, on N tile 0, reads the staged values whose K index is
//   below min(2*Cout, K) back into out[p, j] (bf16: the staged chunks
//   unswizzled and widened; f32: its A fragments, split as for the
//   products, as hi + lo);
// - kProbeNoWin: every tap loads the centre pixel, zero where the shifted
//   tap leaves the image or lies past K (f32: the copy takes the centre
//   tap's offsets, and the consumer zeroes those rows of its fragments).
// Tiling: 64-pixel tiles, TILE_N (set by the packing) 64 for Cout <= 32
// and 128 otherwise (Cout = 128 and 256 take 2 and 4 N tiles). At
// 46x152x256 that gives 110 x 4 = 440 tiles; at 92x304x128 874; at
// 368x1216x32 6992. bf16: STAGES = 4 stages of 24 KB (128 columns); other
// tilings (2-6 stages, two consumer warpgroups, 256-column tiles) were
// measured (PERF.md): none was faster at every level, so this one alone
// is built. f32: 128-pixel tiles (TF32_BM, one per consumer warpgroup
// pair; half the tiles above), a stage 16 KB of raw A and the hi and lo
// weight blocks (48 KB at 128 columns, 32 KB at 64), 4 stages either way
// (3 at 128 columns and 6 at 64 ran no faster; 64-pixel tiles with 2-5
// stages, and reading the next slice's first fragment ahead, were slower
// or no faster: PERF.md).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (the encoder: at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gcw {

constexpr int BK = 64;          // bf16 K slice: 64 bf16 = one 128-byte row
constexpr int TF32_BK = 32;     // f32 K slice: 32 f32 = one 128-byte row
constexpr int ROW_BYTES = 128;  // a swizzled row of A or B
constexpr int BM = 64;          // output pixels a tile: one warpgroup's M
constexpr int STAGES = 4;       // ring depth, bf16
// the f32 kernel: two consumer warpgroups of 64 pixels share each stage
// (128-pixel tiles), then the producer warpgroup; ring depth by tile
// width; at 128 columns the producer hands registers to the consumers
// (setmaxnreg: 40 + 2 x 232 a sub-partition's 3 warps, in its 16K)
constexpr int TF32_CONSUMERS = 2;
constexpr int TF32_BM = 64 * TF32_CONSUMERS;
constexpr int TF32_THREADS = 128 * (TF32_CONSUMERS + 1);
constexpr int TF32_STAGES_N64 = 4, TF32_STAGES_N128 = 4;
constexpr int TF32_PRODUCER_REGS = 40, TF32_CONSUMER_REGS = 232;

// wgmma_kernel's PROBE: the production kernel, or one of K8's modes
enum { kProduction = 0, kProbeFull, kProbeNoPack, kProbePackOnly,
       kProbeNoWin };

struct Args {
  const void* x;        // [B, H, W, Cin] f32 (bf16 storage: bf16),
                        // 16-byte aligned
  const uint8_t* wp;    // packed: bf16 [ntiles, slices, TILE_N, 64] or
                        // f32 [ntiles, slices, 2, TILE_N, 32]
  const float* bias;    // [2*Cout]
  const float* scale;   // [Cout]
  const float* offset;  // [Cout]
  const float* res;     // [B, Ho, Wo, Cout] or nullptr (bf16 storage:
                        // nullptr)
  void* out;            // [B, Ho, Wo, Cout] f32 (bf16 storage: bf16;
                        // K8's probe: [B, Ho, Wo, 2*Cout] f32)
  int B, H, W, Cin, Ho, Wo, Cout, k, stride, pad, relu;
  int K, slices, ntiles;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// of more than ~10 s (2^34 clocks) means a broken ring: trap, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > (1LL << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16) from global to shared
// memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// K-major operand in the 128-byte swizzle: 8-row groups 1024 bytes apart
// (SBO), leading offset unused (1), layout type 1 (B128).
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, A and B K-major in shared
// memory; d is this thread's N/2 accumulator fragments.
__device__ __forceinline__ void mma_n64(float* d, uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_n128(float* d, uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int TILE_N>
__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
  if constexpr (TILE_N == 64) mma_n64(d, da, db);
  else mma_n128(d, da, db);
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v's hi and lo tf32 parts, as 32-bit patterns
__device__ __forceinline__ void split_tf32(float v, uint32_t* hi,
                                           uint32_t* lo) {
  *hi = tf32_rna(v);
  *lo = tf32_rna(v - __uint_as_float(*hi));  // v - hi is exact
}

// wgmma.mma_async m64nNk8, f32 += tf32 x tf32 (f32 = tf32 x tf32 where
// `acc` is false: the accumulator's old value is not read), A and B
// K-major in shared memory (the only layout tf32 takes; no transpose
// operands).
__device__ __forceinline__ void mma_tf32_n64(float* d, uint64_t da,
                                             uint64_t db, bool acc = true) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"((int)acc));
}

__device__ __forceinline__ void mma_tf32_n128(float* d, uint64_t da,
                                              uint64_t db, bool acc = true) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"((int)acc));
}

template <int TILE_N>
__device__ __forceinline__ void mma_tf32(float* d, uint64_t da, uint64_t db,
                                         bool acc) {
  if constexpr (TILE_N == 64) mma_tf32_n64(d, da, db, acc);
  else mma_tf32_n128(d, da, db, acc);
}

// f32 += tf32 x tf32 as above, with A from registers: a[0..3] is this
// thread's A fragment of the k8 step (rows 16 warp + lane/4 (a0, a2) and
// + 8 (a1, a3), columns lane % 4 (a0, a1) and + 4 (a2, a3)), B K-major in
// shared memory.
__device__ __forceinline__ void mma_tf32_rs_n64(float* d, const uint32_t* a,
                                                uint64_t db, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"((int)acc));
}

__device__ __forceinline__ void mma_tf32_rs_n128(float* d, const uint32_t* a,
                                                 uint64_t db, bool acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"((int)acc));
}

template <int TILE_N>
__device__ __forceinline__ void mma_tf32_rs(float* d, const uint32_t* a,
                                            uint64_t db, bool acc) {
  if constexpr (TILE_N == 64) mma_tf32_rs_n64(d, a, db, acc);
  else mma_tf32_rs_n128(d, a, db, acc);
}

// Tell the compiler that d[0..N) change here (after a wgmma wait), so no
// read of them moves above it.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t ld_shared_b32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// The f32 consumer's A fragment of k8 step ks, split into TF32 hi and lo:
// from a raw stage of 64 rows x 32 f32 in the 128-byte swizzle (16-byte
// chunk j of row r at j ^ (r % 8)), `src` the stage + row r0's offset + 4
// (lane % 4) bytes, xg = (r0 % 8) << 4; a0/a2 from row r0, a1/a3 from r0
// + 8, a0/a1 in chunk 2 ks, a2/a3 in 2 ks + 1. keep[h] false zeroes row r0
// + 8 h (K8 nowin).
__device__ __forceinline__ void load_split_a(uint32_t src, uint32_t xg,
                                             int ks, const bool* keep,
                                             uint32_t* hi, uint32_t* lo) {
  const uint32_t c0 = ((uint32_t)(2 * ks) << 4) ^ xg;
  const uint32_t c1 = ((uint32_t)(2 * ks + 1) << 4) ^ xg;
  float v[4];
  v[0] = __uint_as_float(ld_shared_b32(src + c0));
  v[1] = __uint_as_float(ld_shared_b32(src + 8 * ROW_BYTES + c0));
  v[2] = __uint_as_float(ld_shared_b32(src + c1));
  v[3] = __uint_as_float(ld_shared_b32(src + 8 * ROW_BYTES + c1));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!keep[i & 1]) v[i] = 0.0f;
    split_tf32(v[i], &hi[i], &lo[i]);
  }
}

// One TMA im2col load of a raw f32 A stage: the tensor map's box (pixels
// x 32 channels) from channel c, the walk starting at (w, h) of image n with
// the tap's offsets (ow, oh), completing on `bar`'s transaction count.
__device__ __forceinline__ void tma_im2col(uint32_t dst,
                                           const CUtensorMap* map, int c,
                                           int w, int h, int n, uint16_t ow,
                                           uint16_t oh, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w),
      "r"(h), "r"(n), "r"(bar), "h"(ow), "h"(oh)
      : "memory");
}

__device__ __forceinline__ float gate(float f, float g, int relu) {
  if (relu) f = f > 0.0f ? f : expm1f(f);
  return f * (1.0f / (1.0f + expf(-g)));
}

// The epilogue from the accumulator registers of one consumer warpgroup:
// fragment i = 4 j + e is row lane/4 + 8 (e/2), column 8 j + 2 (lane % 4)
// + e % 2; column group j = 2q is f and 2q + 1 is m of channels
// ch0 + 8q + 2 (lane % 4) + e % 2. p[h] is the output pixel of row
// 16 warp + lane/4 + 8h (-1: none). BF16_IO (bf16 storage): each pair is
// rounded once to bf16 (RNE) and stored as one __nv_bfloat162; no
// residual.
template <int TILE_N, bool BF16_IO = false>
__device__ __forceinline__ void epilogue(const Args& a, const float* d,
                                         const int* p, int tile) {
  const int lane = threadIdx.x % 32;
  const int ch0 = tile * (TILE_N / 2) + 2 * (lane % 4);
#pragma unroll
  for (int q = 0; q < TILE_N / 16; ++q) {
    const int c = ch0 + 8 * q;
    if (c >= a.Cout) continue;  // Cout % 8 == 0: c + 1 < Cout too
    const float2 bf = *reinterpret_cast<const float2*>(a.bias + c);
    const float2 bm = *reinterpret_cast<const float2*>(a.bias + a.Cout + c);
    const float2 sc = *reinterpret_cast<const float2*>(a.scale + c);
    const float2 of = *reinterpret_cast<const float2*>(a.offset + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (p[h] < 0) continue;
      float2 o;
      o.x = gate(d[8 * q + 2 * h] + bf.x, d[8 * q + 4 + 2 * h] + bm.x,
                 a.relu) * sc.x + of.x;
      o.y = gate(d[8 * q + 2 * h + 1] + bf.y,
                 d[8 * q + 4 + 2 * h + 1] + bm.y, a.relu) * sc.y + of.y;
      const size_t oi = (size_t)p[h] * a.Cout + c;
      if constexpr (BF16_IO) {
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(a.out) + oi) =
            __float22bfloat162_rn(o);
      } else {
        if (a.res != nullptr) {
          const float2 r = *reinterpret_cast<const float2*>(a.res + oi);
          o.x += r.x;
          o.y += r.y;
        }
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + oi) = o;
      }
    }
  }
}

// K8's epilogue (every probe mode but packonly): the raw sums of the
// fragment map above, f of channel c to out[p, c] and m to out[p, Cout +
// c] (out [.., 2*Cout] f32), no bias, gate or BN; float2 stores.
template <int TILE_N>
__device__ __forceinline__ void raw_epilogue(const Args& a, const float* d,
                                             const int* p, int tile) {
  const int lane = threadIdx.x % 32;
  const int ch0 = tile * (TILE_N / 2) + 2 * (lane % 4);
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int q = 0; q < TILE_N / 16; ++q) {
    const int c = ch0 + 8 * q;
    if (c >= a.Cout) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (p[h] < 0) continue;
      float* o = out + (size_t)p[h] * 2 * a.Cout + c;
      *reinterpret_cast<float2*>(o) =
          make_float2(d[8 * q + 2 * h], d[8 * q + 2 * h + 1]);
      *reinterpret_cast<float2*>(o + a.Cout) =
          make_float2(d[8 * q + 4 + 2 * h], d[8 * q + 4 + 2 * h + 1]);
    }
  }
}

// The bf16 tile loop, persistent: each block walks the output tiles t =
// blockIdx.x, + gridDim.x, ... (BM consecutive pixels of N tile
// t / mblocks), and its producer and consumer run one ring through all of
// them, so one tile's epilogue overlaps the next tile's staging. bf16
// operands read from f32 storage and rounded, or (BF16_IO) read from bf16
// storage as they are, with a bf16 output. PROBE: the production kernel or
// one of K8's modes (note at the top).
template <int TILE_N, bool BF16_IO = false, int PROBE = kProduction>
__global__ void __launch_bounds__(256, 1) wgmma_kernel(const Args a) {
  static_assert(PROBE == kProduction || !BF16_IO, "K8 probes f32 storage");
  constexpr uint32_t A_BYTES = BM * ROW_BYTES, B_BYTES = TILE_N * ROW_BYTES;
  constexpr int ST = STAGES;
  constexpr int KS = BK;       // K a slice: one 128-byte row
  constexpr int CH = KS / 8;   // channels a 16-byte chunk
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sA = base, sB = base + ST * A_BYTES;
  const uint32_t full = sB + ST * B_BYTES, empty = full + 8 * ST;
  const int tid = threadIdx.x, wg = tid / 128;
  const int npix = a.B * a.Ho * a.Wo;
  const int mblocks = (npix + BM - 1) / BM, tiles = mblocks * a.ntiles;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      bar_init(full + 8 * s, 129);
      bar_init(empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 1) {
    // ---- producer warpgroup: pixel rows r0 + 16 i, 16-byte chunk c8
    constexpr int PER = BM / 16;
    const int tp = tid - 128, c8 = tp & 7, r0 = tp >> 3;
    // row m = r0 + 16 i keeps m % 8 = r0 % 8: chunk c8 lands at c8 ^ (m % 8)
    const uint32_t a_off = r0 * ROW_BYTES + ((c8 ^ (r0 & 7)) << 4);
    int g = 0;  // ring stages filled so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % mblocks) * BM;
      int img[PER], iy0[PER], ix0[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int p = m0 + r0 + 16 * i;
        if (p < npix) {
          const int b = p / (a.Ho * a.Wo);
          const int r = p - b * a.Ho * a.Wo;
          const int oy = r / a.Wo;
          img[i] = b * a.H;
          iy0[i] = oy * a.stride - a.pad;
          ix0[i] = (r - oy * a.Wo) * a.stride - a.pad;
        } else {
          img[i] = -1;
          iy0[i] = ix0[i] = 0;
        }
      }
      const uint8_t* wsrc =
          a.wp + (size_t)(t / mblocks) * a.slices * B_BYTES;
      for (int it = 0; it < a.slices; ++it, ++g) {
        const int st = g % ST;
        bar_wait(empty + 8 * st, ((g / ST) & 1) ^ 1);
        if (tp == 0) {
          bar_arrive_tx(full + 8 * st, B_BYTES);
          bulk_copy(sB + st * B_BYTES, wsrc + (size_t)it * B_BYTES, B_BYTES,
                    full + 8 * st);
        }
        const int kidx = it * KS + c8 * CH;
        const bool kin = kidx < a.K;
        const int tap = kin ? kidx / a.Cin : 0;
        const int ci = kidx - tap * a.Cin;
        const int ky = tap / a.k, kx = tap - ky * a.k;
        const uint32_t dst = sA + st * A_BYTES + a_off;
        if constexpr (PROBE == kProbeNoPack) {
          // K8 nopack: no patch loads, no A stores
        } else if constexpr (BF16_IO) {
          // a 16-byte chunk is 8 bf16 channels: stored as loaded
          uint4 u[PER];
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            const int iy = iy0[i] + ky, ix = ix0[i] + kx;
            u[i] = make_uint4(0u, 0u, 0u, 0u);
            if (kin && img[i] >= 0 && iy >= 0 && iy < a.H && ix >= 0 &&
                ix < a.W)
              u[i] = *reinterpret_cast<const uint4*>(
                  static_cast<const __nv_bfloat16*>(a.x) +
                  ((size_t)(img[i] + iy) * a.W + ix) * a.Cin + ci);
          }
#pragma unroll
          for (int i = 0; i < PER; ++i)
            st_shared_v4(dst + i * 16 * ROW_BYTES, u[i]);
        } else {
          float4 v[PER][CH / 4];
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            const int iy = iy0[i] + ky, ix = ix0[i] + kx;
#pragma unroll
            for (int q = 0; q < CH / 4; ++q)
              v[i][q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            // K8 nowin: every tap loads the centre pixel, masked as the
            // shifted tap
            const int ly = PROBE == kProbeNoWin ? iy0[i] + a.pad : iy;
            const int lx = PROBE == kProbeNoWin ? ix0[i] + a.pad : ix;
            if (kin && img[i] >= 0 && iy >= 0 && iy < a.H && ix >= 0 &&
                ix < a.W) {
              const float4* src = reinterpret_cast<const float4*>(
                  static_cast<const float*>(a.x) +
                  ((size_t)(img[i] + ly) * a.W + lx) * a.Cin + ci);
#pragma unroll
              for (int q = 0; q < CH / 4; ++q) v[i][q] = src[q];
            }
          }
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            uint4 hi;
            hi.x = pack_bf16x2(v[i][0].x, v[i][0].y);
            hi.y = pack_bf16x2(v[i][0].z, v[i][0].w);
            hi.z = pack_bf16x2(v[i][1].x, v[i][1].y);
            hi.w = pack_bf16x2(v[i][1].z, v[i][1].w);
            st_shared_v4(dst + i * 16 * ROW_BYTES, hi);
          }
        }
        // generic-proxy stores -> visible to wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_arrive(full + 8 * st);
      }
    }
  } else if constexpr (PROBE == kProbePackOnly) {
    // ---- consumer warpgroup, K8 packonly: no products. Each thread reads
    // chunk c8 of rows r0 + 16 i back from the A stage (chunk j of row m
    // sits at j ^ (m % 8), as the producer stored it) on N tile 0, where
    // its K index is below min(2*Cout, K), and frees the stage.
    constexpr int PER = BM / 16;
    const int c8 = tid & 7, r0 = tid >> 3;
    const uint32_t a_off = r0 * ROW_BYTES + ((c8 ^ (r0 & 7)) << 4);
    const int kmax = min(2 * a.Cout, a.K);  // a multiple of 8 (of CH)
    float* out = static_cast<float*>(a.out);
    int g = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % mblocks) * BM;
      for (int it = 0; it < a.slices; ++it, ++g) {
        const int st = g % ST;
        bar_wait(full + 8 * st, (g / ST) & 1);
        const int kidx = it * KS + c8 * CH;
        if (t < mblocks && kidx < kmax) {
          const uint32_t src = sA + st * A_BYTES + a_off;
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            const int p = m0 + r0 + 16 * i;
            if (p >= npix) continue;
            const uint4 hi = ld_shared_v4(src + i * 16 * ROW_BYTES);
            float4* o = reinterpret_cast<float4*>(
                out + (size_t)p * 2 * a.Cout + kidx);
            // 8 bf16 channels, the first in the low half
            o[0] = make_float4(__uint_as_float(hi.x << 16),
                               __uint_as_float(hi.x & 0xFFFF0000u),
                               __uint_as_float(hi.y << 16),
                               __uint_as_float(hi.y & 0xFFFF0000u));
            o[1] = make_float4(__uint_as_float(hi.z << 16),
                               __uint_as_float(hi.z & 0xFFFF0000u),
                               __uint_as_float(hi.w << 16),
                               __uint_as_float(hi.w & 0xFFFF0000u));
          }
        }
        __syncwarp();
        if (tid % 32 == 0) bar_arrive(empty + 8 * st);
      }
    }
  } else {
    // ---- consumer warpgroup, bf16 operands: pixels m0 .. m0 + 63 of
    // each tile
    const int lane = tid % 32;
    int g = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      float d[TILE_N / 2];
#pragma unroll
      for (int i = 0; i < TILE_N / 2; ++i) d[i] = 0.0f;
      for (int it = 0; it < a.slices; ++it, ++g) {
        const int st = g % ST;
        bar_wait(full + 8 * st, (g / ST) & 1);
        const uint64_t da = desc(sA + st * A_BYTES);
        const uint64_t db = desc(sB + st * B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS / 16; ++ks)  // +32 bytes per k16 step
          mma<TILE_N>(d, da + 2 * ks, db + 2 * ks);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's group has retired
        if (it > 0 && lane == 0) bar_arrive(empty + 8 * ((g - 1) % ST));
      }
      wgmma_wait<0>();
      if (lane == 0) bar_arrive(empty + 8 * ((g - 1) % ST));
      const int row = (t % mblocks) * BM + 16 * (tid / 32) + lane / 4;
      const int p[2] = {row < npix ? row : -1,
                        row + 8 < npix ? row + 8 : -1};
      if constexpr (PROBE == kProduction)
        epilogue<TILE_N, BF16_IO>(a, d, p, t / mblocks);
      else
        raw_epilogue<TILE_N>(a, d, p, t / mblocks);
    }
  }
}

// The f32 tile loop (three TF32 products), persistent as the bf16 one,
// over tiles of TF32_BM pixels: one thread of the last warp copies each
// slice's raw f32 patch (TMA im2col through `xmap`) and weight block into
// the ring; each of the TF32_CONSUMERS warpgroups before it reads its 64
// rows' A fragments from the raw stage, splits them in registers and
// issues the register-A products against the shared weight block. PROBE:
// the production kernel or one of K8's modes (note at the top).
template <int TILE_N>
__host__ __device__ constexpr int tf32_stages() {
  return TILE_N == 64 ? TF32_STAGES_N64 : TF32_STAGES_N128;
}

// Whether the kernel moves registers from its producer to its consumers
template <int TILE_N, int PROBE>
__host__ __device__ constexpr bool rebalanced() {
  return TILE_N == 128 && PROBE != kProbePackOnly;
}

template <int TILE_N, int PROBE = kProduction>
__global__ void __launch_bounds__(TF32_THREADS, 1)
    wgmma_tf32_kernel(const Args a, const __grid_constant__ CUtensorMap xmap) {
  constexpr uint32_t A_BYTES = TF32_BM * ROW_BYTES;  // raw f32: 128 x 32
  constexpr uint32_t B_PART = TILE_N * ROW_BYTES, B_BYTES = 2 * B_PART;
  constexpr int ST = tf32_stages<TILE_N>();
  constexpr int KS = TF32_BK;  // K a slice: one 128-byte f32 row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sA = base, sB = base + ST * A_BYTES;
  const uint32_t full = sB + ST * B_BYTES, empty = full + 8 * ST;
  const int tid = threadIdx.x;
  const int npix = a.B * a.Ho * a.Wo;
  const int mblocks = (npix + TF32_BM - 1) / TF32_BM;
  const int tiles = mblocks * a.ntiles;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      bar_init(full + 8 * s, 1);  // the producer's byte-count arrive
      bar_init(empty + 8 * s, 4 * TF32_CONSUMERS);  // a consumer warp's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the consumers' accumulators and fragments at 128 columns need more
  // than the 168 registers a thread the launch gives 384 threads (K8
  // packonly holds neither)
  constexpr bool REBALANCE = rebalanced<TILE_N, PROBE>();
  if (tid >= 128 * TF32_CONSUMERS) {
    // ---- producer: one thread posts each stage's bytes and issues its
    // two copies; the rest of its warpgroup has nothing to do
    if constexpr (REBALANCE)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          TF32_PRODUCER_REGS));
    if (tid != 128 * TF32_CONSUMERS) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&xmap))
                 : "memory");
    constexpr uint32_t TX = PROBE == kProbeNoPack ? B_BYTES
                                                  : A_BYTES + B_BYTES;
    const int hw = a.Ho * a.Wo;
    int g = 0;  // ring stages filled so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      // the tile's first pixel, as the im2col walk's start: image n, the
      // top-left tap of output (oy, ox); the walk goes on along the
      // bounding box's rows and images (ops/gated_conv.py
      // `im2col_copy_params`), so pixel m0 + i is row i
      const int m0 = (t % mblocks) * TF32_BM;
      const int n = m0 / hw, r = m0 - n * hw, oy = r / a.Wo;
      const int w0 = (r - oy * a.Wo) * a.stride - a.pad;
      const int h0 = oy * a.stride - a.pad;
      const uint8_t* wsrc =
          a.wp + (size_t)(t / mblocks) * a.slices * B_BYTES;
      for (int it = 0; it < a.slices; ++it, ++g) {
        const int st = g % ST;
        bar_wait(empty + 8 * st, ((g / ST) & 1) ^ 1);
        bar_arrive_tx(full + 8 * st, TX);
        bulk_copy(sB + st * B_BYTES, wsrc + (size_t)it * B_BYTES, B_BYTES,
                  full + 8 * st);
        if constexpr (PROBE != kProbeNoPack) {  // K8 nopack: no A copy
          const int kidx = it * KS, tap = kidx / a.Cin;
          const int ky = tap / a.k, kx = tap - ky * a.k;
          // K8 nowin: every tap copies the centre tap
          const int ow = PROBE == kProbeNoWin ? a.pad : kx;
          const int oh = PROBE == kProbeNoWin ? a.pad : ky;
          tma_im2col(sA + st * A_BYTES, &xmap, kidx - tap * a.Cin, w0, h0,
                     n, (uint16_t)ow, (uint16_t)oh, full + 8 * st);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: warpgroup c takes pixels m0 + 64 c .. m0 +
  // 64 c + 63 of each tile. Thread (warp, lane) holds A rows r0 = 16 warp
  // + lane/4 and r0 + 8, columns lane % 4 and + 4 of each k8 step (wgmma's
  // register-A fragment for tf32, in its warpgroup's 64 rows): words of
  // 16-byte chunks 2 ks and 2 ks + 1, which the 128-byte swizzle puts at
  // chunk ^ (r0 % 8) in both rows (r0 % 8 = lane / 4).
  if constexpr (REBALANCE)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        TF32_CONSUMER_REGS));
  const int lane = tid % 32, grp = lane / 4;
  const int r0 = 16 * (tid / 32) + grp;  // of the tile's 128 rows
  const uint32_t a_row = r0 * ROW_BYTES + 4 * (lane % 4);
  const uint32_t xg = (uint32_t)grp << 4;
  int g = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row = (t % mblocks) * TF32_BM + r0;
    const int p[2] = {row < npix ? row : -1, row + 8 < npix ? row + 8 : -1};
    // K8 nowin: the rows' output pixels (image row and column), to zero
    // where the shifted tap leaves the image
    int py[2] = {0, 0}, px[2] = {0, 0};
    if constexpr (PROBE == kProbeNoWin) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = p[h] < 0 ? 0 : p[h] % (a.Ho * a.Wo);
        py[h] = (q / a.Wo) * a.stride - a.pad;
        px[h] = (q % a.Wo) * a.stride - a.pad;
      }
    }
    float d[TILE_N / 2], sum[TILE_N / 2];
#pragma unroll
    for (int i = 0; i < TILE_N / 2; ++i) d[i] = sum[i] = 0.0f;
    for (int it = 0; it < a.slices; ++it, ++g) {
      const int st = g % ST;
      bar_wait(full + 8 * st, (g / ST) & 1);
      const uint32_t src = sA + st * A_BYTES + a_row;
      bool keep[2] = {true, true};
      if constexpr (PROBE == kProbeNoWin) {
        const int tap = it * KS / a.Cin;
        const int ky = tap / a.k, kx = tap - ky * a.k;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          keep[h] = py[h] + ky >= 0 && py[h] + ky < a.H && px[h] + kx >= 0 &&
                    px[h] + kx < a.W;
      }
      uint32_t hi[KS / 8][4], lo[KS / 8][4];
      if constexpr (PROBE == kProbePackOnly) {
        // K8 packonly: no products; on N tile 0 the split fragments go to
        // out[p, K index] as hi + lo, below min(2*Cout, K)
        const int kmax = min(2 * a.Cout, a.K);
        float* out = static_cast<float*>(a.out);
#pragma unroll
        for (int ks = 0; ks < KS / 8; ++ks) {
          load_split_a(src, xg, ks, keep, hi[ks], lo[ks]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int pi = p[i & 1];
            const int j = it * KS + 8 * ks + lane % 4 + 4 * (i >> 1);
            if (t < mblocks && pi >= 0 && j < kmax)
              out[(size_t)pi * 2 * a.Cout + j] =
                  __uint_as_float(hi[ks][i]) + __uint_as_float(lo[ks][i]);
          }
        }
        __syncwarp();
        if (lane == 0) bar_arrive(empty + 8 * st);
      } else {
        const uint64_t db = desc(sB + st * B_BYTES);
        const uint64_t dbl = db + (B_PART >> 4);  // the lo block
        // each k8 step: read and split its fragment, then its three
        // products; the next step's reads run while they do
#pragma unroll
        for (int ks = 0; ks < KS / 8; ++ks) {  // B: +32 bytes a k8 step
          load_split_a(src, xg, ks, keep, hi[ks], lo[ks]);
          wgmma_fence();
          mma_tf32_rs<TILE_N>(d, hi[ks], db + 2 * ks, ks > 0);
          mma_tf32_rs<TILE_N>(d, hi[ks], dbl + 2 * ks, true);
          mma_tf32_rs<TILE_N>(d, lo[ks], db + 2 * ks, true);
        }
        wgmma_commit();
        wgmma_wait<0>();  // this stage's group has retired
        fence_regs<TILE_N / 2>(d);
        if (lane == 0) bar_arrive(empty + 8 * st);
#pragma unroll
        for (int i = 0; i < TILE_N / 2; ++i) sum[i] += d[i];
      }
    }
    if constexpr (PROBE == kProduction)
      epilogue<TILE_N>(a, sum, p, t / mblocks);
    else if constexpr (PROBE != kProbePackOnly)
      raw_epilogue<TILE_N>(a, sum, p, t / mblocks);
  }
}

// Dynamic shared memory of one block: the A and B stages, the full and
// empty barriers, and 1 KB to align the stages to the swizzle's 1024
// bytes. bf16: a stage is [BM + TILE_N] rows of 128 bytes; f32: the raw A
// rows and the hi and lo weight blocks, [TF32_BM + 2 TILE_N] rows.
template <int TILE_N>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * (BM + TILE_N) * ROW_BYTES + 16 * STAGES + 1024;
}

template <int TILE_N>
constexpr size_t tf32_smem_bytes() {
  return (size_t)tf32_stages<TILE_N>() *
             ((TF32_BM + 2 * TILE_N) * ROW_BYTES + 16) +
         1024;
}

// How many blocks of `kern` (`threads` threads, `smem` bytes of dynamic
// shared memory) fit on the current device at once, in *blocks. The first call
// for a device raises the kernel's shared-memory limit to the device's
// maximum and asks for its SM count and occupancy; cache[device] keeps
// the answer (0: not asked yet), so each device is asked once.
constexpr int MAX_DEVICES = 64;

inline int resident_blocks(const void* kern, size_t smem, int* cache,
                           int* blocks, int threads = 256) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev < 0 || dev >= MAX_DEVICES))
    e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && cache[dev] == 0) {
    int optin = 0, sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
    if (e == cudaSuccess && per_sm == 0) e = cudaErrorInvalidValue;
    if (e == cudaSuccess) cache[dev] = per_sm * sms;
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return (int)e;
  }
  *blocks = cache[dev];
  return 0;
}

// Launch as many blocks as fit on the device at once (at most one a
// tile), for each TILE_N, bf16 mode and PROBE.
template <int TILE_N, bool BF16_IO = false, int PROBE = kProduction>
int launch(const Args& a, cudaStream_t stream) {
  static int cache[MAX_DEVICES];
  auto kern = wgmma_kernel<TILE_N, BF16_IO, PROBE>;
  constexpr size_t smem = smem_bytes<TILE_N>();
  int most = 0;
  const int e = resident_blocks(reinterpret_cast<const void*>(kern), smem,
                                cache, &most);
  if (e != 0) return e;
  const int npix = a.B * a.Ho * a.Wo;
  const int tiles = (npix + BM - 1) / BM * a.ntiles;
  kern<<<tiles < most ? tiles : most, 256, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeIm2col (the driver's, CUDA 12.0 ABI), found once a
// process through the runtime, so the library links only cudart; null if
// the driver has none.
typedef CUresult (*EncodeIm2col)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const int*, const int*, cuuint32_t, cuuint32_t,
    const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeIm2col im2col_encoder() {
  static const EncodeIm2col fn = []() -> EncodeIm2col {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeIm2col", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeIm2col", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return nullptr;
    }
    return reinterpret_cast<EncodeIm2col>(p);
  }();
  return fn;
}

// The f32 loop's tensor map of x [B, H, W, Cin] f32 for its TMA im2col
// loads (ops/gated_conv.py `im2col_copy_params` computes the same): dims
// innermost first (Cin, W, H, B), byte strides, a bounding box from -pad
// (lower corner) to pad - (k - 1) (upper corner, from the far edge) in W
// and H, so that its positions at the traversal stride (the conv's
// stride) are the output pixels' top-left taps; 32 channels x TF32_BM
// pixels a load, the 128-byte swizzle, zero fill out of bounds. 0, or
// cudaErrorInvalidValue if the encoder refuses (cudaErrorNotSupported if
// the driver has none).
inline int encode_im2col(const Args& a, CUtensorMap* map) {
  const EncodeIm2col encode = im2col_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t cin = (cuuint64_t)a.Cin, w = (cuuint64_t)a.W,
                   h = (cuuint64_t)a.H;
  const cuuint64_t dims[4] = {cin, w, h, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {cin * 4, w * cin * 4, h * w * cin * 4};
  const int lower[2] = {-a.pad, -a.pad};
  const int upper[2] = {a.pad - (a.k - 1), a.pad - (a.k - 1)};
  const cuuint32_t elem[4] = {1, (cuuint32_t)a.stride, (cuuint32_t)a.stride,
                              1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(a.x), dims,
      strides, lower, upper, TF32_BK, TF32_BM, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Whether the block's registers at launch (the kernel's count a thread x
// TF32_THREADS) hold the producer's and the consumers' after setmaxnreg,
// which would wait for them for ever otherwise.
inline bool rebalance_fits(const void* kern) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kern) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return attr.numRegs * TF32_THREADS >=
         128 * TF32_PRODUCER_REGS + 128 * TF32_CONSUMERS * TF32_CONSUMER_REGS;
}

// The f32 loop's launch: as `launch`, with x's tensor map encoded for the
// call.
template <int TILE_N, int PROBE = kProduction>
int launch_tf32(const Args& a, cudaStream_t stream) {
  static int cache[MAX_DEVICES];
  auto kern = wgmma_tf32_kernel<TILE_N, PROBE>;
  constexpr size_t smem = tf32_smem_bytes<TILE_N>();
  int most = 0;
  int e = resident_blocks(reinterpret_cast<const void*>(kern), smem, cache,
                          &most, TF32_THREADS);
  if (e != 0) return e;
  if constexpr (rebalanced<TILE_N, PROBE>()) {  // asked once a process
    static const bool fits =
        rebalance_fits(reinterpret_cast<const void*>(kern));
    if (!fits) return (int)cudaErrorInvalidConfiguration;
  }
  CUtensorMap xmap;
  e = encode_im2col(a, &xmap);
  if (e != 0) return e;
  const int npix = a.B * a.Ho * a.Wo;
  const int tiles = (npix + TF32_BM - 1) / TF32_BM * a.ntiles;
  kern<<<tiles < most ? tiles : most, TF32_THREADS, smem, stream>>>(a, xmap);
  return (int)cudaGetLastError();
}

// Columns of one N tile (f and m together) for Cout: 64 for Cout <= 32,
// else 128, as ops/gated_conv.py `wgmma_tile_n` packs the weight.
inline int tile_n_for(int Cout) { return Cout <= 32 ? 64 : 128; }

// What both C entries of this loop (gated_conv.cu's gated_conv_kxk_wgmma,
// K8's gated_conv_probe.cu) check before they launch, and the launch at
// the packing's tile width: Cin % 32 == 0, Cout % 8 == 0, x and the
// packed weight 16-byte aligned, tile_n 64 or 128 and a.ntiles its N
// tiles; cudaErrorInvalidValue for anything else, no launch for no
// pixels.
template <bool TF32, bool BF16_IO = false, int PROBE = kProduction>
int checked_launch(const Args& a, int tile_n, cudaStream_t stream) {
  static_assert(!(TF32 && BF16_IO), "bf16 storage has bf16 operands");
  if (a.Cin % 32 != 0 || a.Cout % 8 != 0 ||
      reinterpret_cast<uintptr_t>(a.x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.wp) % 16 != 0 ||
      (tile_n != 64 && tile_n != 128) ||
      a.ntiles != (a.Cout + tile_n / 2 - 1) / (tile_n / 2))
    return (int)cudaErrorInvalidValue;
  if (a.B * a.Ho * a.Wo == 0) return (int)cudaGetLastError();
  if constexpr (TF32)
    return tile_n == 64 ? launch_tf32<64, PROBE>(a, stream)
                        : launch_tf32<128, PROBE>(a, stream);
  else
    return tile_n == 64 ? launch<64, BF16_IO, PROBE>(a, stream)
                        : launch<128, BF16_IO, PROBE>(a, stream);
}

}  // namespace gcw
