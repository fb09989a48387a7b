// K2's bf16 route for Hopper: a persistent, warp-specialized wgmma tile
// loop fed by an mbarrier ring of staged tiles (`gated_conv_kxk_wgmma`,
// gated_conv.cu).
//
// Replaces, for bf16 operands (JAX's `mxu_bf16`), read_tpu/ops/
// gated_conv_pack.py `_conv3x3_chw_dot3_kernel` (:190, pallas_call :392)
// and the strided transitions read_tpu/models/unet_pallas.py `_Ctx.conv`
// routes through space-to-depth or im2col (:178-219). It takes the calls
// with Cin % 32 == 0, Cout % 8 == 0 and a 16-byte aligned x; the rest
// (the 8-channel descriptor inputs, the Cout = 3 heads, f32) keep the
// tile loops of gated_conv_tile.cuh. Python routes (ops/gated_conv.py
// `kxk_route`).
//
// What bounds it: at the 32-channel full-resolution layer (368x1216) the
// f32 activations read and written (0.034 ms at 3.35 TB/s against 0.017 ms
// of bf16 tensor-core work); at the deeper levels the tensor-core
// operations (0.017 ms a 3x3 layer). It runs at 5-7x that (PERF.md), with
// the tensor cores mostly idle: fewer barrier arrivals changed nothing,
// and more registers a thread (one block per SM instead of two) made it
// slower, so the number of stages each SM keeps in flight sets its pace.
//
// Design. A channels-last implicit GEMM: M = output pixels, N = the
// layer's f|m columns, K = k*k*Cin tap-major, in 64-deep slices (two taps
// of 32 channels at Cin = 32; one tap's 64 channels otherwise).
// - Weights: `pack_kxk_bf16` (ops/gated_conv.py) packs them once per
//   module into bf16 blocks of [TILE_N rows (n), 64 (k)], one contiguous
//   block per (N tile, K slice), already in the 128-byte swizzle the wgmma
//   descriptor reads, with f and m columns interleaved in groups of 8
//   ([f c0..7 | m c0..7 | f c8..15 | ...]). One `cp.async.bulk` per stage
//   brings a block in; no tensor map, so the build links only cudart.
// - Producer warpgroup (the block's last 128 threads): per slice, waits
//   for the stage to be empty, has one thread post the weight block's byte
//   count and issue its bulk copy, then all 128 load the input patch as
//   16-byte f32 vectors (zero outside the image, past K and past the last
//   pixel; stride and k = 4 by index arithmetic), round to bf16
//   (`__floats2bfloat162_rn`, RNE as torch's .to(bfloat16)) and store the
//   swizzled A stage; `fence.proxy.async.shared::cta` makes those generic
//   stores visible to wgmma before each thread's arrive on the stage's
//   full barrier (129 arrivals: 128 threads + the byte-count arrive).
// - Consumer warpgroup (the block's first 128 threads, 64 pixels): waits
//   for the full barrier, issues 4 `wgmma.mma_async m64nTILE_Nk16` from
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
// Tiling: 64-pixel tiles, STAGES = 4, and TILE_N (set by the packing) 64
// for Cout <= 32 and 128 otherwise (Cout = 128 and 256 take 2 and 4 N
// tiles). At 46x152x256 that gives 110 x 4 = 440 tiles; at 92x304x128
// 874; at 368x1216x32 6992. Other tilings (2-6 stages, two consumer
// warpgroups, 256-column tiles) were measured (PERF.md): none was faster
// at every level, so this one alone is built.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gcw {

constexpr int BK = 64;          // K slice: 64 bf16 = one 128-byte row
constexpr int ROW_BYTES = 128;  // a swizzled row of A or B
constexpr int BM = 64;          // output pixels a tile: one warpgroup's M
constexpr int STAGES = 4;       // ring depth

struct Args {
  const float* x;       // [B, H, W, Cin] f32, 16-byte aligned
  const uint8_t* wp;    // packed bf16 [ntiles, slices, TILE_N, 64]
  const float* bias;    // [2*Cout]
  const float* scale;   // [Cout]
  const float* offset;  // [Cout]
  const float* res;     // [B, Ho, Wo, Cout] or nullptr
  float* out;           // [B, Ho, Wo, Cout]
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

__device__ __forceinline__ float gate(float f, float g, int relu) {
  if (relu) f = f > 0.0f ? f : expm1f(f);
  return f * (1.0f / (1.0f + expf(-g)));
}

// The epilogue from the accumulator registers of one consumer warpgroup:
// fragment i = 4 j + e is row lane/4 + 8 (e/2), column 8 j + 2 (lane % 4)
// + e % 2; column group j = 2q is f and 2q + 1 is m of channels
// ch0 + 8q + 2 (lane % 4) + e % 2. p[h] is the output pixel of row
// 16 warp + lane/4 + 8h (-1: none).
template <int TILE_N>
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
      if (a.res != nullptr) {
        const float2 r = *reinterpret_cast<const float2*>(a.res + oi);
        o.x += r.x;
        o.y += r.y;
      }
      *reinterpret_cast<float2*>(a.out + oi) = o;
    }
  }
}

// The tile loop, persistent: each block walks the output tiles t =
// blockIdx.x, + gridDim.x, ... (BM consecutive pixels of N tile
// t / mblocks), and its producer and consumer run one ring through all of
// them, so one tile's epilogue overlaps the next tile's staging.
template <int TILE_N>
__global__ void __launch_bounds__(256, 1) wgmma_kernel(const Args a) {
  constexpr uint32_t A_BYTES = BM * ROW_BYTES, B_BYTES = TILE_N * ROW_BYTES;
  constexpr int ST = STAGES;
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
    // ---- producer warpgroup: pixel rows r0 + 16 i, 8-channel chunk c8
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
        const int kidx = it * BK + c8 * 8;
        const bool kin = kidx < a.K;
        const int tap = kin ? kidx / a.Cin : 0;
        const int ci = kidx - tap * a.Cin;
        const int ky = tap / a.k, kx = tap - ky * a.k;
        float4 v[PER][2];
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int iy = iy0[i] + ky, ix = ix0[i] + kx;
          v[i][0] = v[i][1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (kin && img[i] >= 0 && iy >= 0 && iy < a.H && ix >= 0 &&
              ix < a.W) {
            const float4* src = reinterpret_cast<const float4*>(
                a.x + ((size_t)(img[i] + iy) * a.W + ix) * a.Cin + ci);
            v[i][0] = src[0];
            v[i][1] = src[1];
          }
        }
        const uint32_t dst = sA + st * A_BYTES + a_off;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          uint4 pk;
          pk.x = pack_bf16x2(v[i][0].x, v[i][0].y);
          pk.y = pack_bf16x2(v[i][0].z, v[i][0].w);
          pk.z = pack_bf16x2(v[i][1].x, v[i][1].y);
          pk.w = pack_bf16x2(v[i][1].z, v[i][1].w);
          st_shared_v4(dst + i * 16 * ROW_BYTES, pk);
        }
        // generic-proxy stores -> visible to wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_arrive(full + 8 * st);
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
      for (int it = 0; it < a.slices; ++it, ++g) {
        const int st = g % ST;
        bar_wait(full + 8 * st, (g / ST) & 1);
        const uint64_t da = desc(sA + st * A_BYTES);
        const uint64_t db = desc(sB + st * B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)  // +32 bytes per k16 step
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
      epilogue<TILE_N>(a, d, p, t / mblocks);
    }
  }
}

// Dynamic shared memory of one block: the A and B stages, the full and
// empty barriers, and 1 KB to align the stages to the swizzle's 1024 bytes.
template <int TILE_N>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * (BM + TILE_N) * ROW_BYTES + 16 * STAGES + 1024;
}

// Launch as many blocks as fit on the card at once (at most one a tile).
// The shared-memory limit is raised to the card's maximum and the blocks
// per SM are asked once, for each TILE_N.
template <int TILE_N>
int launch(const Args& a, cudaStream_t stream) {
  static int sms = 0, per_sm = 0;
  auto kern = wgmma_kernel<TILE_N>;
  constexpr size_t smem = smem_bytes<TILE_N>();
  cudaError_t e = cudaSuccess;
  if (per_sm == 0) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, 0);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 256,
                                                        smem);
    if (e != cudaSuccess || per_sm == 0) {
      per_sm = 0;
      cudaGetLastError();  // clear it, or the next launch would report it
      return e != cudaSuccess ? (int)e : (int)cudaErrorInvalidValue;
    }
  }
  const int npix = a.B * a.Ho * a.Wo;
  const int tiles = (npix + BM - 1) / BM * a.ntiles;
  const int most = per_sm * sms;
  kern<<<tiles < most ? tiles : most, 256, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace gcw
