// K3 and K4 for Hopper: one persistent, warp-specialized wgmma loop for
// the gated 1x1 conv over the channel concat of 1 to 4 inputs
// (`gated_conv_1x1_wgmma`, gated_conv.cu).
//
// Replaces read_tpu/ops/gated_conv_pack.py `_conv1x1_chw_kernel` (:421,
// pallas_call :491; K3, one input) and `_conv1x1_cat_kernel` (:509,
// pallas_call :599; K4, the concat never written). It takes the gated
// calls whose inputs all have C_j % 8 == 0 and 16-byte aligned data, with
// Cout % 8 == 0 and 8-byte aligned bias, scale, offset and residual (the
// epilogue reads channel pairs): all 9 K3/K4 calls of a full-width
// frame. The rest (K4
// with gated = 0, other widths, misaligned views) keep the tile loops of
// gated_conv_tile.cuh. Python routes (ops/gated_conv.py `conv1x1_route`).
// It also takes K7 1x1, scripts/gated_conv_pallas_r2.py `_conv1x1_kernel`
// (:169, pallas_call :202), as K3 with one input of one image and no
// residual, in f32 (TF32 x3) or with x, w and the output all bf16 (the
// bf16-storage mode below; ops/gated_conv_r2.py `r2_route`).
//
// What bounds it: the bytes, at the frame's shapes (K = 16..256 input
// channels, 32..512 f|m columns: a few floats read and written a pixel
// against 2 K flops a column; even three TF32 products sit below the
// card's operations-per-byte line). What holds it back on an H100
// (PERF.md): the gated epilogue, run by one warpgroup a block from its
// accumulator registers; a probe without it ran several times faster,
// one without the input loads barely faster. So the tiling buys blocks
// per SM: 64-column tiles and a 2-stage ring (3 f32 / 4 bf16 blocks an
// SM) ran fastest of 2-4 stages and 64/128 columns.
//
// Three modes, one loop; each computes the function it is asked for:
// - bf16 (JAX's `mxu_bf16`): the producer rounds the input to bf16 (RNE)
//   and one `wgmma m64nNk16 .bf16` product a k16 step sums in f32: K2's
//   arithmetic. A K slice is 64 channels (one 128-byte bf16 row).
// - f32: no exact f32 tensor-core product exists, and one TF32 product
//   misses the f32 bound. Each operand v is split as hi = rna_tf32(v), lo
//   = rna_tf32(v - hi) (`cvt.rna.tf32.f32`, round to nearest, ties away
//   from zero), and three `wgmma m64nNk8 .tf32` products a k8 step sum
//   hi*hi + hi*lo + lo*hi into one f32 accumulator: the dropped lo*lo
//   term and lo's own rounding are ~2^-22 of each product. So the route
//   is not exact f32 FMA, but is held to the f32 bound (atol 2e-5, rtol
//   1e-4) against the plain f32 twin. A K slice is 32 channels (one
//   128-byte f32 row), staged as an hi and a lo part.
// - bf16 storage (BF16_IO; K7's bf16 contract): the input and the output
//   are bf16 in memory; each 16-byte chunk (8 channels) goes into the A
//   stage as loaded, the products are the bf16 mode's, and the epilogue
//   rounds each f32 channel pair once to a __nv_bfloat162 (K2's loop
//   note).
//
// Design, on K2's pattern (gated_conv_wgmma.cuh, whose barriers,
// descriptors, bulk copy, TF32 split and products and epilogue it uses):
// M = pixels (rows of the [n, C_j] inputs: no taps, halo or stride), N =
// the layer's f|m columns interleaved by 8, K = the concatenated input
// channels.
// - Weights: packed once per module (ops/gated_conv.py `pack_1x1_bf16`,
//   `pack_1x1_tf32`; cached on BasicConv) into one block per (N tile, K
//   slice) in the 128-byte swizzle: [64, 64] bf16, or [2, 64, 32] f32
//   (the hi block, then the lo block). One `cp.async.bulk` a stage.
// - Producer warpgroup: per slice, each thread loads one 16-byte chunk
//   (8 bf16-bound or 4 f32 channels) of 4 pixel rows; the chunk lies in
//   one input, because every C_j % 8 == 0 (gc::CatSrc finds it). It
//   converts (bf16 RNE; or tf32 hi and lo), stores the swizzled A part(s)
//   and fences (`fence.proxy.async.shared::cta`) before its arrive.
// - Consumer warpgroup (64 pixels): 4 bf16 or 12 tf32 wgmmas a slice with
//   one group in flight; the epilogue (bias, ELU * sigmoid, BN affine,
//   residual) runs from the accumulator registers (gcw::epilogue).
// - Persistent blocks walk tiles t, t + gridDim.x, ... through one ring of
//   STAGES stages. Tiling: 64 pixels x 64 f|m columns (32 channels; Cout =
//   256 takes 8 N tiles), 2 stages of 128 x 128 bytes (bf16, 32 KB) or
//   twice that (f32, 64 KB).

#pragma once

#include "gated_conv_tile.cuh"
#include "gated_conv_wgmma.cuh"

namespace gc1 {

using gcw::BM;
using gcw::ROW_BYTES;
constexpr int TILE_N = 64;  // f|m columns a tile: 32 output channels
constexpr int STAGES = 2;

struct Args {
  gcw::Args e;     // wp, the epilogue's pointers, Cout, relu, K, slices,
                   // ntiles; B = H = 1, W = Wo = n pixels, Cin = K
  gc::CatSrc src;  // the inputs x_j [n, C_j]
};

// The loop. TF32: f32 operands as three tf32 products; else bf16, read
// from f32 storage and rounded, or (BF16_IO) read from bf16 storage as
// they are, with a bf16 output.
template <bool TF32, bool BF16_IO = false>
__global__ void __launch_bounds__(256, 1) conv1x1_kernel(const Args a) {
  static_assert(!(TF32 && BF16_IO), "bf16 storage has bf16 operands");
  constexpr int P = TF32 ? 2 : 1;  // parts of an operand: hi (and lo)
  constexpr uint32_t A_PART = BM * ROW_BYTES, B_PART = TILE_N * ROW_BYTES;
  constexpr uint32_t A_BYTES = P * A_PART, B_BYTES = P * B_PART;
  constexpr int KS = TF32 ? 32 : 64;  // channels a slice: 128-byte rows
  constexpr int CH = KS / 8;          // channels a 16-byte chunk
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (gcw::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sA = base, sB = base + STAGES * A_BYTES;
  const uint32_t full = sB + STAGES * B_BYTES, empty = full + 8 * STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  const int n = a.e.Wo;
  const int mblocks = (n + BM - 1) / BM, tiles = mblocks * a.e.ntiles;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      gcw::bar_init(full + 8 * s, 129);
      gcw::bar_init(empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 1) {
    // ---- producer warpgroup: pixel rows r0 + 16 i, 16-byte chunk c8
    constexpr int PER = BM / 16;
    const int tp = tid - 128, c8 = tp & 7, r0 = tp >> 3;
    const uint32_t a_off = r0 * ROW_BYTES + ((c8 ^ (r0 & 7)) << 4);
    int g = 0;  // ring stages filled so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % mblocks) * BM;
      const uint8_t* wsrc =
          a.e.wp + (size_t)(t / mblocks) * a.e.slices * B_BYTES;
      for (int it = 0; it < a.e.slices; ++it, ++g) {
        const int st = g % STAGES;
        gcw::bar_wait(empty + 8 * st, ((g / STAGES) & 1) ^ 1);
        if (tp == 0) {
          gcw::bar_arrive_tx(full + 8 * st, B_BYTES);
          gcw::bulk_copy(sB + st * B_BYTES, wsrc + (size_t)it * B_BYTES,
                         B_BYTES, full + 8 * st);
        }
        const int kidx = it * KS + c8 * CH;
        const bool kin = kidx < a.e.K;  // K % 8 == 0: the whole chunk
        int o = 0, cj = 0;
        const float* xj = a.src.at(kin ? kidx : 0, &o, &cj);
        const uint32_t dst = sA + st * A_BYTES + a_off;
        if constexpr (BF16_IO) {
          // x_j holds bf16: a 16-byte chunk is 8 channels, stored as
          // loaded
          uint4 u[PER];
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            const int p = m0 + r0 + 16 * i;
            u[i] = make_uint4(0u, 0u, 0u, 0u);
            if (kin && p < n)
              u[i] = *reinterpret_cast<const uint4*>(
                  reinterpret_cast<const __nv_bfloat16*>(xj) +
                  (size_t)p * cj + (kidx - o));
          }
#pragma unroll
          for (int i = 0; i < PER; ++i)
            gcw::st_shared_v4(dst + i * 16 * ROW_BYTES, u[i]);
        } else {
          float4 v[PER][CH / 4];
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            const int p = m0 + r0 + 16 * i;
#pragma unroll
            for (int q = 0; q < CH / 4; ++q)
              v[i][q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (kin && p < n) {
              const float4* src = reinterpret_cast<const float4*>(
                  xj + (size_t)p * cj + (kidx - o));
#pragma unroll
              for (int q = 0; q < CH / 4; ++q) v[i][q] = src[q];
            }
          }
#pragma unroll
          for (int i = 0; i < PER; ++i) {
            uint4 hi, lo;
            if constexpr (TF32) {
              gcw::split_tf32(v[i][0].x, &hi.x, &lo.x);
              gcw::split_tf32(v[i][0].y, &hi.y, &lo.y);
              gcw::split_tf32(v[i][0].z, &hi.z, &lo.z);
              gcw::split_tf32(v[i][0].w, &hi.w, &lo.w);
              gcw::st_shared_v4(dst + A_PART + i * 16 * ROW_BYTES, lo);
            } else {
              hi.x = gcw::pack_bf16x2(v[i][0].x, v[i][0].y);
              hi.y = gcw::pack_bf16x2(v[i][0].z, v[i][0].w);
              hi.z = gcw::pack_bf16x2(v[i][CH / 4 - 1].x,
                                      v[i][CH / 4 - 1].y);
              hi.w = gcw::pack_bf16x2(v[i][CH / 4 - 1].z,
                                      v[i][CH / 4 - 1].w);
            }
            gcw::st_shared_v4(dst + i * 16 * ROW_BYTES, hi);
          }
        }
        // generic-proxy stores -> visible to wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        gcw::bar_arrive(full + 8 * st);
      }
    }
  } else {
    // ---- consumer warpgroup: pixels m0 .. m0 + 63 of each tile
    const int lane = tid % 32;
    int g = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      float d[TILE_N / 2];
#pragma unroll
      for (int i = 0; i < TILE_N / 2; ++i) d[i] = 0.0f;
      for (int it = 0; it < a.e.slices; ++it, ++g) {
        const int st = g % STAGES;
        gcw::bar_wait(full + 8 * st, (g / STAGES) & 1);
        const uint64_t da = gcw::desc(sA + st * A_BYTES);
        const uint64_t db = gcw::desc(sB + st * B_BYTES);
        gcw::wgmma_fence();
        if constexpr (TF32) {
          // the lo parts: A_PART and B_PART bytes on, in 16-byte units
          const uint64_t dal = da + (A_PART >> 4), dbl = db + (B_PART >> 4);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {  // +32 bytes per k8 step
            gcw::mma_tf32_n64(d, da + 2 * ks, db + 2 * ks);
            gcw::mma_tf32_n64(d, da + 2 * ks, dbl + 2 * ks);
            gcw::mma_tf32_n64(d, dal + 2 * ks, db + 2 * ks);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)  // +32 bytes per k16 step
            gcw::mma_n64(d, da + 2 * ks, db + 2 * ks);
        }
        gcw::wgmma_commit();
        gcw::wgmma_wait<1>();  // the previous stage's group has retired
        if (it > 0 && lane == 0)
          gcw::bar_arrive(empty + 8 * ((g - 1) % STAGES));
      }
      gcw::wgmma_wait<0>();
      if (lane == 0) gcw::bar_arrive(empty + 8 * ((g - 1) % STAGES));
      const int row = (t % mblocks) * BM + 16 * (tid / 32) + lane / 4;
      const int p[2] = {row < n ? row : -1, row + 8 < n ? row + 8 : -1};
      gcw::epilogue<TILE_N, BF16_IO>(a.e, d, p, t / mblocks);
    }
  }
}

// Dynamic shared memory of one block: the A and B stages, the barriers,
// and 1 KB to align the stages to the swizzle's 1024 bytes.
template <bool TF32>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * (TF32 ? 2 : 1) * (BM + TILE_N) * ROW_BYTES +
         16 * STAGES + 1024;
}

// Launch as many blocks as fit on the device at once (at most one a tile).
template <bool TF32, bool BF16_IO = false>
int launch(const Args& a, cudaStream_t stream) {
  static int cache[gcw::MAX_DEVICES];
  auto kern = conv1x1_kernel<TF32, BF16_IO>;
  constexpr size_t smem = smem_bytes<TF32>();
  int most = 0;
  const int e = gcw::resident_blocks(reinterpret_cast<const void*>(kern),
                                     smem, cache, &most);
  if (e != 0) return e;
  const int tiles = (a.e.Wo + BM - 1) / BM * a.e.ntiles;
  kern<<<tiles < most ? tiles : most, 256, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace gc1
