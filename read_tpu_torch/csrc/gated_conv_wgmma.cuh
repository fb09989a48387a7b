// K2 for Hopper: a persistent, warp-specialized wgmma tile loop fed by an
// mbarrier ring of staged tiles (`gated_conv_kxk_wgmma`, gated_conv.cu),
// in two operand modes.
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
// Three modes, one loop (template arguments TF32 and BF16_IO):
// - bf16 (JAX's `mxu_bf16`): the producer rounds the input to bf16 (RNE,
//   as torch's .to(bfloat16)) and one `wgmma m64nNk16 .bf16` product a
//   k16 step sums in f32. A K slice is 64 channels (one 128-byte row).
// - bf16 storage (BF16_IO; K7's bf16 contract): x and the output are
//   bf16 in memory. The producer stores each 16-byte chunk (8 channels)
//   into the swizzled A stage as it was loaded, with no conversion; the
//   products are the bf16 mode's; the epilogue computes in f32, rounds
//   each channel pair once (RNE) and stores it as one __nv_bfloat162. No
//   residual. A plain load and shared store, as in the other modes:
//   `cp.async` copies, each stage handed over once the next one's were in
//   flight, gave no consistent gain over the bench levels (slower at 32
//   channels; PERF.md), and that hand-over deadlocks a 2-stage ring whose
//   consumer keeps one stage in flight (the 1x1 loop's).
// - f32: three TF32 products, as the 1x1 loop's f32 mode
//   (gated_conv_1x1_wgmma.cuh): each operand v is split as hi =
//   rna_tf32(v), lo = rna_tf32(v - hi) (`split_tf32`), and three `wgmma
//   m64nNk8 .tf32` products a k8 step sum hi*hi + hi*lo + lo*hi into one
//   f32 sum. Not exact f32 FMA, but held to the f32 bound (atol 2e-5, rtol
//   1e-4) against the plain f32 twin up to K = 9 * 256. A K slice is 32
//   channels of one tap (one 128-byte f32 row; Cin % 32 == 0, so no slice
//   straddles two taps), staged as an hi and a lo part. The tensor cores'
//   own f32 accumulation drifted past that bound over K >= 1024, so each
//   slice's products start a fresh wgmma sum, added into f32 registers
//   (IEEE adds) once its group has retired.
//
// What bounds it: at the 32-channel full-resolution layer (368x1216) the
// f32 activations read and written (0.034 ms at 3.35 TB/s against 0.017 ms
// of bf16 tensor-core work); at the deeper levels the tensor-core
// operations (0.017 ms a 3x3 layer in bf16, 6x that as three TF32
// products). The bf16 mode runs at 5-7x that (PERF.md), with the tensor
// cores mostly idle: fewer barrier arrivals changed nothing, and more
// registers a thread (one block per SM instead of two) made it slower,
// so the number of stages each SM keeps in flight sets its pace. The f32
// mode runs at ~3.4x its TF32 bound over a frame, 0.6x cuDNN's exact f32;
// neither a deeper ring nor two blocks an SM moved it (PERF.md). K8's
// modes (below) say which phase that is: the producer's staging (PERF.md
// section 6 gives each mode's time at the four bench levels).
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
//   f c8..15 | ...]). One `cp.async.bulk` per stage brings it in; no
//   tensor map, so the build links only cudart.
// - Producer warpgroup (the block's last 128 threads): per slice, waits
//   for the stage to be empty, has one thread post the weight block's byte
//   count and issue its bulk copy, then all 128 load the input patch as
//   16-byte f32 vectors (zero outside the image, past K and past the last
//   pixel; stride and k = 4 by index arithmetic), convert them (bf16 RNE,
//   or TF32 hi and lo) and store the swizzled A part(s);
//   `fence.proxy.async.shared::cta` makes those generic stores visible to
//   wgmma before each thread's arrive on the stage's full barrier (129
//   arrivals: 128 threads + the byte-count arrive).
// - Consumer warpgroup (the block's first 128 threads, 64 pixels): waits
//   for the full barrier, issues 4 bf16 or 12 tf32 `wgmma.mma_async` from
//   shared memory, commits, keeps that group in flight (`wait_group 1`)
//   and frees the previous stage (one arrive per warp on its empty
//   barrier).
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
// - kProbeNoPack: the producer skips the patch loads and the A stores (it
//   still posts the weight bytes, copies, fences and arrives), so the
//   products run over stale shared memory: timing only;
// - kProbePackOnly: the producer as in full; the consumer issues no
//   product and, on N tile 0, reads the staged chunks whose K index is
//   below min(2*Cout, K) back from the A stage (unswizzled) into out[p, j]
//   (bf16: widened; TF32: hi + lo);
// - kProbeNoWin: every tap loads the centre pixel, zero where the shifted
//   tap leaves the image or lies past K.
// Tiling: 64-pixel tiles, TILE_N (set by the packing) 64 for Cout <= 32
// and 128 otherwise (Cout = 128 and 256 take 2 and 4 N tiles). At
// 46x152x256 that gives 110 x 4 = 440 tiles; at 92x304x128 874; at
// 368x1216x32 6992. bf16: STAGES = 4 stages of 24 KB (128 columns); other
// tilings (2-6 stages, two consumer warpgroups, 256-column tiles) were
// measured (PERF.md): none was faster at every level, so this one alone
// is built. f32: a stage is twice as large (48 KB at 128 columns) and a
// consumer thread holds two accumulator sets (153 registers at 128
// columns: one block an SM); TF32_STAGES = 3 ran fastest of 2, 3 and 4,
// and 64-column tiles (two blocks an SM) ran no faster (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gcw {

constexpr int BK = 64;          // bf16 K slice: 64 bf16 = one 128-byte row
constexpr int TF32_BK = 32;     // f32 K slice: 32 f32 = one 128-byte row
constexpr int ROW_BYTES = 128;  // a swizzled row of A or B
constexpr int BM = 64;          // output pixels a tile: one warpgroup's M
constexpr int STAGES = 4;       // ring depth, bf16
constexpr int TF32_STAGES = 3;  // ring depth, f32 (three TF32 products)

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

// The tile loop, persistent: each block walks the output tiles t =
// blockIdx.x, + gridDim.x, ... (BM consecutive pixels of N tile
// t / mblocks), and its producer and consumer run one ring through all of
// them, so one tile's epilogue overlaps the next tile's staging. TF32:
// f32 operands as three tf32 products; else bf16, read from f32 storage
// and rounded, or (BF16_IO) read from bf16 storage as they are, with a
// bf16 output. PROBE: the production kernel or one of K8's modes (note at
// the top).
template <int TILE_N, bool TF32, bool BF16_IO = false,
          int PROBE = kProduction>
__global__ void __launch_bounds__(256, 1) wgmma_kernel(const Args a) {
  static_assert(!(TF32 && BF16_IO), "bf16 storage has bf16 operands");
  static_assert(PROBE == kProduction || !BF16_IO, "K8 probes f32 storage");
  constexpr int P = TF32 ? 2 : 1;  // parts of an operand: hi (and lo)
  constexpr uint32_t A_PART = BM * ROW_BYTES, B_PART = TILE_N * ROW_BYTES;
  constexpr uint32_t A_BYTES = P * A_PART, B_BYTES = P * B_PART;
  constexpr int ST = TF32 ? TF32_STAGES : STAGES;
  constexpr int KS = TF32 ? TF32_BK : BK;  // K a slice: one 128-byte row
  constexpr int CH = KS / 8;               // channels a 16-byte chunk
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
            uint4 hi, lo;
            if constexpr (TF32) {
              split_tf32(v[i][0].x, &hi.x, &lo.x);
              split_tf32(v[i][0].y, &hi.y, &lo.y);
              split_tf32(v[i][0].z, &hi.z, &lo.z);
              split_tf32(v[i][0].w, &hi.w, &lo.w);
              st_shared_v4(dst + A_PART + i * 16 * ROW_BYTES, lo);
            } else {
              hi.x = pack_bf16x2(v[i][0].x, v[i][0].y);
              hi.y = pack_bf16x2(v[i][0].z, v[i][0].w);
              hi.z = pack_bf16x2(v[i][CH / 4 - 1].x, v[i][CH / 4 - 1].y);
              hi.w = pack_bf16x2(v[i][CH / 4 - 1].z, v[i][CH / 4 - 1].w);
            }
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
            if constexpr (TF32) {
              const uint4 lo =
                  ld_shared_v4(src + A_PART + i * 16 * ROW_BYTES);
              o[0] = make_float4(
                  __uint_as_float(hi.x) + __uint_as_float(lo.x),
                  __uint_as_float(hi.y) + __uint_as_float(lo.y),
                  __uint_as_float(hi.z) + __uint_as_float(lo.z),
                  __uint_as_float(hi.w) + __uint_as_float(lo.w));
            } else {  // 8 bf16 channels, the first in the low half
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
        }
        __syncwarp();
        if (tid % 32 == 0) bar_arrive(empty + 8 * st);
      }
    }
  } else if constexpr (TF32) {
    // ---- consumer warpgroup, f32 operands: pixels m0 .. m0 + 63 of each
    // tile. The tensor cores' f32 accumulation does not round to nearest:
    // over K2's up to 9 x 256 = 2304 channels its error grew past the f32
    // bound (PERF.md). So each slice's three products start a fresh wgmma
    // sum (d, `acc` false on its first product) and are added into sum
    // with IEEE adds once that slice's group has retired (wait_group 0).
    const int lane = tid % 32;
    int g = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      float d[TILE_N / 2], sum[TILE_N / 2];
#pragma unroll
      for (int i = 0; i < TILE_N / 2; ++i) d[i] = sum[i] = 0.0f;
      for (int it = 0; it < a.slices; ++it, ++g) {
        const int st = g % ST;
        bar_wait(full + 8 * st, (g / ST) & 1);
        const uint64_t da = desc(sA + st * A_BYTES);
        const uint64_t db = desc(sB + st * B_BYTES);
        // the lo parts: A_PART and B_PART bytes on, in 16-byte units
        const uint64_t dal = da + (A_PART >> 4), dbl = db + (B_PART >> 4);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS / 8; ++ks) {  // +32 bytes per k8 step
          mma_tf32<TILE_N>(d, da + 2 * ks, db + 2 * ks, ks > 0);
          mma_tf32<TILE_N>(d, da + 2 * ks, dbl + 2 * ks, true);
          mma_tf32<TILE_N>(d, dal + 2 * ks, db + 2 * ks, true);
        }
        wgmma_commit();
        wgmma_wait<0>();  // this stage's group has retired
        if (lane == 0) bar_arrive(empty + 8 * st);
#pragma unroll
        for (int i = 0; i < TILE_N / 2; ++i) sum[i] += d[i];
      }
      const int row = (t % mblocks) * BM + 16 * (tid / 32) + lane / 4;
      const int p[2] = {row < npix ? row : -1,
                        row + 8 < npix ? row + 8 : -1};
      if constexpr (PROBE == kProduction)
        epilogue<TILE_N>(a, sum, p, t / mblocks);
      else
        raw_epilogue<TILE_N>(a, sum, p, t / mblocks);
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

// Dynamic shared memory of one block: the A and B stages (twice as large
// in TF32 mode: hi and lo parts), the full and empty barriers, and 1 KB to
// align the stages to the swizzle's 1024 bytes.
template <int TILE_N, bool TF32>
constexpr size_t smem_bytes() {
  constexpr int ST = TF32 ? TF32_STAGES : STAGES;
  return (size_t)ST * (TF32 ? 2 : 1) * (BM + TILE_N) * ROW_BYTES + 16 * ST +
         1024;
}

// How many blocks of `kern` (256 threads, `smem` bytes of dynamic shared
// memory) fit on the current device at once, in *blocks. The first call
// for a device raises the kernel's shared-memory limit to the device's
// maximum and asks for its SM count and occupancy; cache[device] keeps
// the answer (0: not asked yet), so each device is asked once.
constexpr int MAX_DEVICES = 64;

inline int resident_blocks(const void* kern, size_t smem, int* cache,
                           int* blocks) {
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
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 256,
                                                        smem);
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
// tile), for each TILE_N, operand mode and PROBE.
template <int TILE_N, bool TF32, bool BF16_IO = false,
          int PROBE = kProduction>
int launch(const Args& a, cudaStream_t stream) {
  static int cache[MAX_DEVICES];
  auto kern = wgmma_kernel<TILE_N, TF32, BF16_IO, PROBE>;
  constexpr size_t smem = smem_bytes<TILE_N, TF32>();
  int most = 0;
  const int e = resident_blocks(reinterpret_cast<const void*>(kern), smem,
                                cache, &most);
  if (e != 0) return e;
  const int npix = a.B * a.Ho * a.Wo;
  const int tiles = (npix + BM - 1) / BM * a.ntiles;
  kern<<<tiles < most ? tiles : most, 256, smem, stream>>>(a);
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
  if (a.Cin % 32 != 0 || a.Cout % 8 != 0 ||
      reinterpret_cast<uintptr_t>(a.x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(a.wp) % 16 != 0 ||
      (tile_n != 64 && tile_n != 128) ||
      a.ntiles != (a.Cout + tile_n / 2 - 1) / (tile_n / 2))
    return (int)cudaErrorInvalidValue;
  if (a.B * a.Ho * a.Wo == 0) return (int)cudaGetLastError();
  return tile_n == 64 ? launch<64, TF32, BF16_IO, PROBE>(a, stream)
                      : launch<128, TF32, BF16_IO, PROBE>(a, stream);
}

}  // namespace gcw
