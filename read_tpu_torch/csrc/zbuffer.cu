// The z-buffers for Hopper: K1 (projecting, packed int32 key), K5
// (projecting, exact 64-bit key), the pyramid pass that turns either key
// buffer into every level of the index pyramid, and K6 (given packed
// keys). K1 and K5 share one projection, so they pick the same pixel for
// every point, bit for bit.
//
// K1 replaces read_tpu/ops/rasterize_pallas.py `_kernel2` (via
// `zbuffer_pallas2` / `zbuffer_scatter1_pallas`) together with the XLA
// projection and `pack_keys` that feed it (rasterize.py:81-131,
// rasterize_pallas.py:295-308). Per pixel it keeps the minimum of the
// packed int32 key `(q << idb) | id`, q = trunc(clip(depth * qmax, 0,
// qmax - 1)), over the points of each view.
//
// K5 replaces read_tpu/ops/rasterize_pallas.py `_kernel` (via
// `zbuffer_pallas` / `rasterize_pallas`), the exact z-buffer that
// rasterize.py's default 'sort' method (`_zbuffer_sort`) also computes:
// per pixel the least depth, ties to the least id. Its key is
// `(float bits of depth) << 32 | id` in 64 bits: a depth in [0, 1] is a
// non-negative float, and those order like their bit patterns, so the
// key's minimum is the (depth, id) lexicographic minimum, with no depth
// quantization and no limit on the number of points below 2^31.
//
// The pyramid pass replaces K5's output unpack, K1's winner-depth gather
// and the 2x2 pools that follow both (read_tpu/ops/rasterize.py
// `_pool2x2_zbuffer` :574-599, `_pool2x2_packed` :602-634, as
// `rasterize_pyramid_pooled` :637-669 runs them). Both pools are the
// minimum of one key over each 2x2 block: the packed pool's int32 key,
// and for the exact pool the 64-bit key above (depths lie in [0, 1] and
// are never -0.0; an empty pixel, ~0, is farther than any point).
//
// K6 replaces read_tpu/ops/rasterize_pallas.py `_kernel3` (via
// `zbuffer_pallas3`, and `_kernel2`'s contract on given keys): the
// per-pixel minimum of keys the caller packed, pix [N] or [B, N] -> [B,
// n_pixels], empty INT32_MAX. Its one user path in the JAX package is the
// splat (read_tpu/ops/rasterize.py `rasterize` :346-401 and
// `_rasterize_batch_pallas_splat` :404-463): every point expanded into
// (2r+1)^2 offset copies along the point axis, [B, N*K] pixel ids and
// keys written out and handed to the given-key kernel (or sorted, for
// 'sort'). On Hopper that path is the splat projection below: one thread
// a point over all views, as K1/K5, that projects the point once a view,
// computes its splat radius and does one atomicMin for each pixel of its
// square that lies in the frame and passes the coverage test, with K5's
// exact key or K1's packed key (id bits from N points, not N*K). The
// [B, N*K] arrays (72 MB at r=1, 1M points, one view) are never written;
// the pyramid pass takes the key buffer as it takes K1's or K5's. Bound:
// 12 bytes a point (16 with per-point sizes) and the levels written once;
// up to (2r+1)^2 atomics a (view, point) into an L2-resident key buffer,
// which more likely set the pace (PERF.md). `zbuffer_keys` keeps the
// literal given-key contract: one thread per key, one atomicMin; a pix
// outside [0, n_pixels) returns at once (no dump slot). The TPU kernel's
// (8, 128)-tiled framebuffer, a layout for VMEM row read-modify-writes,
// has no use here.
//
// What bounds them on this card. Bytes: K1 and K5 read 12 bytes of xyz
// a point and do at most one atomicMin a (view, point) into a key buffer
// that stays in the 50 MB L2 (1.8 / 3.6 MB at 1216x368, 2 MB at 256x256
// B=8 for K5); the pass reads the key buffer once and writes 8 bytes a
// pixel of every level (~1.33x level 0's pixels at 4 levels). With B
// views the projection also does B times its arithmetic a point (three
// correctly rounded divisions, products kept apart from the adds): at
// B=8 that, not the bytes, is the likely limit (PERF.md).
//
// Design. Projection: one thread per point, looping over the B views, so
// each point's 12 bytes are read once and not B times; the views'
// matrices are staged in shared memory once a block, 32 at a time. Each
// (view, point) inside the frame does one atomicMin; the TPU kernels
// walked the points in order on one core and needed a dump row (K1) or a
// scalar branch (K5) for invalid points, while here min is
// order-independent, so the result is deterministic with no lock, and
// invalid points simply skip (no dump slot: a million atomics on one
// address would serialize). Loading the current key first and issuing
// the atomic only where the new key is smaller was slower at both the
// frame's and the training step's shapes (PERF.md), so every valid
// (view, point) does its atomicMin. The projection uses the _rn
// intrinsics so nvcc cannot contract the expanded product into FMAs: the
// result is bit-equal to the element-wise PyTorch twin, which keeps JAX's
// order ((m0*x + m1*y) + m2*z) + m3.
// Pyramid pass: one block per (tile of level 0, view). The block reads
// its keys once, 16 bytes a thread where the row is aligned, writes level
// 0's (index, depth) and the pooling key of each pixel into shared
// memory, then reduces each coarser level in shared memory (ping-pong
// between two arrays) and writes it: the key buffer is read once and
// each level written once, in one launch for all levels. K1's level-0
// depth is the winner's own projection (`project_point` on xyz[id], bit
// for bit the depth K1 packed), so K1 on this path writes no per-point
// depths. A tile is max(32, 2^(L-1)) x max(64, 2^(L-1)) pixels of level
// 0, so each coarse pixel of L levels lies in one tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kViewsPerStage = 32;   // matrices staged in shared memory
constexpr int kTileH = 32, kTileW = 64;
constexpr int kMaxRadius = 16;       // the splat's largest half-width
constexpr unsigned kEmpty32 = 0x7fffffffu;   // INT32_MAX
constexpr unsigned long long kEmpty64 = ~0ull;

__device__ __forceinline__ float row_dot(const float* r, float x, float y,
                                         float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r[0], x),
                                       __fmul_rn(r[1], y)),
                             __fmul_rn(r[2], z)),
                   r[3]);
}

// Projects point (x, y, z) by the row-major world->clip matrix m. Sets
// *depth to (ndc_z + 1) * 0.5 and *cz to the clip-space z before the
// divide, and returns true when the point lies in the clip cube; then
// sets (*u, *v) to its pixel, which may lie one past the frame's last
// column or row (ndc x = 1 or y = -1).
__device__ __forceinline__ bool project_uv(const float* m, float x, float y,
                                           float z, int h, int w, int* u,
                                           int* v, float* depth,
                                           float* cz) {
  const float cx = row_dot(m, x, y, z);
  const float cy = row_dot(m + 4, x, y, z);
  *cz = row_dot(m + 8, x, y, z);
  const float cw = row_dot(m + 12, x, y, z);
  const float nx = __fdiv_rn(cx, cw);
  const float ny = __fdiv_rn(cy, cw);
  const float nz = __fdiv_rn(*cz, cw);
  *depth = __fmul_rn(__fadd_rn(nz, 1.0f), 0.5f);
  // NaN fails every comparison, so a NaN coordinate is invalid, as in JAX
  if (!(fabsf(nx) <= 1.0f && fabsf(ny) <= 1.0f && fabsf(nz) <= 1.0f &&
        cw > 0.0f)) {
    return false;
  }
  // u = floor((w * (x + 1)) * 0.5), v = floor((h * (1 - y)) * 0.5)
  *u = (int)floorf(
      __fmul_rn(__fmul_rn((float)w, __fadd_rn(nx, 1.0f)), 0.5f));
  *v = (int)floorf(
      __fmul_rn(__fmul_rn((float)h, __fsub_rn(1.0f, ny)), 0.5f));
  return true;
}

// project_uv's point as a flat pixel id in *pix, -1 off the h x w frame.
__device__ __forceinline__ bool project_point(const float* m, float x,
                                              float y, float z, int h,
                                              int w, int* pix,
                                              float* depth) {
  int u, v;
  float cz;
  if (!project_uv(m, x, y, z, h, w, &u, &v, depth, &cz)) return false;
  *pix = (u < 0 || u >= w || v < 0 || v >= h) ? -1 : v * w + u;
  return true;
}

// The packed key's depth bin: trunc(clip(depth * qmax, 0, qmax - 1))
__device__ __forceinline__ unsigned depth_bin(float depth, int qmax) {
  return (unsigned)(int)fminf(fmaxf(__fmul_rn(depth, (float)qmax), 0.0f),
                              (float)(qmax - 1));
}

__device__ __forceinline__ unsigned long long exact_key(float depth,
                                                        int id) {
  return ((unsigned long long)__float_as_uint(depth) << 32) | (unsigned)id;
}

// K1 (EXACT false: packed int32 keys, and each point's depth into depth0
// where it is not null) and K5 (EXACT true: 64-bit keys). keys [B, h*w].
template <bool EXACT>
__global__ void __launch_bounds__(kThreads)
    project_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ mats, int n, int nviews,
                   int h, int w, int idb, int qmax, void* __restrict__ keys,
                   float* __restrict__ depth0) {
  __shared__ float m[kViewsPerStage * 16];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (live) {
    x = xyz[3 * (size_t)i];
    y = xyz[3 * (size_t)i + 1];
    z = xyz[3 * (size_t)i + 2];
  }
  const size_t npx = (size_t)h * w;
  for (int b0 = 0; b0 < nviews; b0 += kViewsPerStage) {
    const int nb = min(kViewsPerStage, nviews - b0);
    __syncthreads();
    for (int j = threadIdx.x; j < 16 * nb; j += blockDim.x) {
      m[j] = mats[16 * (size_t)b0 + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int vb = 0; vb < nb; ++vb) {
      const int b = b0 + vb;
      int pix;
      float depth;
      const bool valid = project_point(m + 16 * vb, x, y, z, h, w, &pix,
                                       &depth);
      if (!EXACT && depth0 != nullptr) {
        depth0[(size_t)b * n + i] = valid ? depth : 0.0f;
      }
      if (!valid || pix < 0) continue;
      // K1's keys are non-negative int32: they order alike as unsigned.
      if (EXACT) {
        atomicMin((unsigned long long*)keys + b * npx + pix,
                  exact_key(depth, i));
      } else {
        atomicMin((unsigned*)keys + b * npx + pix,
                  (depth_bin(depth, qmax) << idb) | (unsigned)i);
      }
    }
  }
}

// The splat's arguments (K6 on its user path).
struct SplatArgs {
  const float* sizes;   // [N] per-point sizes, or null: 2r+1 each
  int radius;           // r: the square's half-width, every size's cap
  int varying;          // sizes or `relative`: the coverage test runs
  int relative;         // z-scaled: max(min_size, size / max(cz, 1e-6))
  float min_size;
  float thr[kMaxRadius + 1];   // thr[k] = float32(k - 1e-4), k >= 1
};

// jnp.maximum and jnp.minimum: a NaN operand gives NaN (fmaxf and fminf
// return the other operand)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// The half-width of the square a point covers: r, or with per-point or
// z-scaled sizes the largest k <= r with rad >= thr[k], rad = (min(size,
// 2r+1) - 1) * 0.5 as JAX computes it (the centre is always covered; a
// NaN size covers the centre alone). thr rises with k, so the offsets
// that pass JAX's test `rad >= max(|dy|, |dx|) - 1e-4` are exactly that
// square.
__device__ __forceinline__ int splat_reach(const SplatArgs& s, float base,
                                           float cz) {
  if (!s.varying) return s.radius;
  float size = base;
  if (s.relative) {
    size = nan_max(s.min_size, __fdiv_rn(base, nan_max(cz, 1e-6f)));
  }
  size = nan_min(size, (float)(2 * s.radius + 1));
  const float rad = __fmul_rn(__fsub_rn(size, 1.0f), 0.5f);
  int k = 0;
#pragma unroll
  for (int j = 1; j <= kMaxRadius; ++j) {
    if (j <= s.radius && rad >= s.thr[j]) k = j;
  }
  return k;
}

// K6 on its user path: the splat projection (EXACT true: K5's 64-bit
// key, for 'sort'; false: K1's packed int32 key, id bits from N points).
// Every pixel of a valid point's square that lies in the frame gets one
// atomicMin of the point's key: the centre pixel may itself lie off the
// frame (u == w or v == h) while its left or upper neighbours do not.
template <bool EXACT>
__global__ void __launch_bounds__(kThreads)
    splat_kernel(const float* __restrict__ xyz,
                 const float* __restrict__ mats, int n, int nviews, int h,
                 int w, int idb, int qmax, void* __restrict__ keys,
                 const SplatArgs s) {
  __shared__ float m[kViewsPerStage * 16];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  float base = (float)(2 * s.radius + 1);
  if (live) {
    x = xyz[3 * (size_t)i];
    y = xyz[3 * (size_t)i + 1];
    z = xyz[3 * (size_t)i + 2];
    if (s.sizes != nullptr) base = s.sizes[i];
  }
  const size_t npx = (size_t)h * w;
  for (int b0 = 0; b0 < nviews; b0 += kViewsPerStage) {
    const int nb = min(kViewsPerStage, nviews - b0);
    __syncthreads();
    for (int j = threadIdx.x; j < 16 * nb; j += blockDim.x) {
      m[j] = mats[16 * (size_t)b0 + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int vb = 0; vb < nb; ++vb) {
      const int b = b0 + vb;
      int u, v;
      float depth, cz;
      if (!project_uv(m + 16 * vb, x, y, z, h, w, &u, &v, &depth, &cz)) {
        continue;
      }
      const int k = splat_reach(s, base, cz);
      const int y0 = max(v - k, 0), y1 = min(v + k, h - 1);
      const int x0 = max(u - k, 0), x1 = min(u + k, w - 1);
      if (EXACT) {
        const unsigned long long key = exact_key(depth, i);
        unsigned long long* row = (unsigned long long*)keys + b * npx;
        for (int yy = y0; yy <= y1; ++yy) {
          for (int xx = x0; xx <= x1; ++xx) {
            atomicMin(row + (size_t)yy * w + xx, key);
          }
        }
      } else {
        const unsigned key = (depth_bin(depth, qmax) << idb) | (unsigned)i;
        unsigned* row = (unsigned*)keys + b * npx;
        for (int yy = y0; yy <= y1; ++yy) {
          for (int xx = x0; xx <= x1; ++xx) {
            atomicMin(row + (size_t)yy * w + xx, key);
          }
        }
      }
    }
  }
}

// The pass's arguments that do not change from block to block.
struct PyramidArgs {
  const void* keys;     // [B, h*w]: uint64 (EXACT_IN) or uint32
  const float* xyz;     // K1: the winners' projection
  const float* mats;
  int nviews, h, w, levels, tile_h, tile_w, idb, qmax;
  int* index;           // level after level, each [B, h_l, w_l]
  float* depth;         // the same layout
};

// Level 0 of one (view, tile): VEC keys a thread-load, their (index,
// depth) written out and their pooling keys put in pool0 (pitch tile_w).
template <bool EXACT_IN, bool EXACT_POOL, int VEC, typename PoolKey>
__device__ __forceinline__ void level0(const PyramidArgs& a, const float* m,
                                       int b, int y0, int x0, int rows,
                                       int cols, PoolKey* pool0) {
  using InKey = typename std::conditional<EXACT_IN, unsigned long long,
                                          unsigned>::type;
  const InKey* keys = (const InKey*)a.keys;
  const int vrow = cols / VEC;
  const size_t base = ((size_t)b * a.h + y0) * a.w + x0;
  const unsigned mask = (1u << a.idb) - 1u;
  for (int u = threadIdx.x; u < rows * vrow; u += blockDim.x) {
    const int r = u / vrow, c = (u - r * vrow) * VEC;
    const size_t g = base + (size_t)r * a.w + c;
    InKey k[VEC];
    if constexpr (VEC == 1) {
      k[0] = keys[g];
    } else if constexpr (sizeof(InKey) == 8) {   // VEC == 2
      const ulonglong2 v = *(const ulonglong2*)(keys + g);
      k[0] = v.x;
      k[1] = v.y;
    } else {                                        // VEC == 4
      const uint4 v = *(const uint4*)(keys + g);
      k[0] = v.x;
      k[1] = v.y;
      k[2] = v.z;
      k[3] = v.w;
    }
    int ix[VEC];
    float dp[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      PoolKey pk;
      if constexpr (EXACT_IN) {
        const bool empty = k[j] == kEmpty64;
        ix[j] = empty ? -1 : (int)(unsigned)(k[j] & 0xffffffffull);
        dp[j] = empty ? 0.0f : __uint_as_float((unsigned)(k[j] >> 32));
        if constexpr (EXACT_POOL) {
          pk = k[j];
        } else {
          pk = empty ? kEmpty32
                     : (depth_bin(dp[j], a.qmax) << a.idb) | (unsigned)ix[j];
        }
      } else {
        // the fill, ~0, is empty (and so is INT32_MAX)
        const bool empty = k[j] >= kEmpty32;
        ix[j] = empty ? -1 : (int)(k[j] & mask);
        dp[j] = 0.0f;
        if (!empty) {
          const size_t p = 3 * (size_t)ix[j];
          int pix;
          project_point(m, a.xyz[p], a.xyz[p + 1], a.xyz[p + 2], a.h, a.w,
                        &pix, &dp[j]);
        }
        if constexpr (EXACT_POOL) {
          pk = empty ? kEmpty64 : exact_key(dp[j], ix[j]);
        } else {
          pk = empty ? kEmpty32 : k[j];
        }
      }
      if (pool0 != nullptr) pool0[r * a.tile_w + c + j] = pk;
    }
    if constexpr (VEC == 4) {
      *(int4*)(a.index + g) = make_int4(ix[0], ix[1], ix[2], ix[3]);
      *(float4*)(a.depth + g) = make_float4(dp[0], dp[1], dp[2], dp[3]);
    } else if constexpr (VEC == 2) {
      *(int2*)(a.index + g) = make_int2(ix[0], ix[1]);
      *(float2*)(a.depth + g) = make_float2(dp[0], dp[1]);
    } else {
      a.index[g] = ix[0];
      a.depth[g] = dp[0];
    }
  }
}

// One block per (tile of level 0, view): grid (tiles across, tiles down,
// B). Dynamic shared memory: tile_h * tile_w * 5/4 pooling keys when
// levels > 1.
template <bool EXACT_IN, bool EXACT_POOL>
__global__ void __launch_bounds__(kThreads)
    pyramid_kernel(const PyramidArgs a, int vec) {
  using PoolKey = typename std::conditional<EXACT_POOL, unsigned long long,
                                            unsigned>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m[16];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * a.tile_h, x0 = blockIdx.x * a.tile_w;
  // h, w and the tile are multiples of 2^(levels-1): so are rows, cols
  const int rows = min(a.tile_h, a.h - y0), cols = min(a.tile_w, a.w - x0);
  if (!EXACT_IN) {
    if (threadIdx.x < 16) m[threadIdx.x] = a.mats[16 * b + threadIdx.x];
    __syncthreads();
  }
  PoolKey* pool[2] = {(PoolKey*)smem,
                      (PoolKey*)smem + a.tile_h * a.tile_w};
  PoolKey* pool0 = a.levels > 1 ? pool[0] : nullptr;
  if (vec) {
    level0<EXACT_IN, EXACT_POOL, EXACT_IN ? 2 : 4>(a, m, b, y0, x0, rows,
                                                   cols, pool0);
  } else {
    level0<EXACT_IN, EXACT_POOL, 1>(a, m, b, y0, x0, rows, cols, pool0);
  }
  long long off = 0;   // level l's first pixel in index / depth
  int hl = a.h, wl = a.w;
  const unsigned mask = (1u << a.idb) - 1u;
  for (int l = 1; l < a.levels; ++l) {
    off += (long long)a.nviews * hl * wl;
    hl >>= 1;
    wl >>= 1;
    __syncthreads();   // level l - 1 is in pool[(l - 1) & 1]
    const PoolKey* src = pool[(l - 1) & 1];
    PoolKey* dst = pool[l & 1];
    const int sp = a.tile_w >> (l - 1), dpitch = a.tile_w >> l;
    const int rl = rows >> l, cl = cols >> l;
    const size_t base = off + ((size_t)b * hl + (y0 >> l)) * wl + (x0 >> l);
    for (int u = threadIdx.x; u < rl * cl; u += blockDim.x) {
      const int r = u / cl, c = u - r * cl;
      const PoolKey* s = src + 2 * r * sp + 2 * c;
      const PoolKey k = min(min(s[0], s[1]), min(s[sp], s[sp + 1]));
      dst[r * dpitch + c] = k;
      int ix;
      float dp;
      if constexpr (EXACT_POOL) {
        const bool empty = k == kEmpty64;
        ix = empty ? -1 : (int)(unsigned)(k & 0xffffffffull);
        dp = empty ? 0.0f : __uint_as_float((unsigned)(k >> 32));
      } else {
        const bool empty = k == kEmpty32;
        ix = empty ? -1 : (int)(k & mask);
        // a true division, as the twin's (and JAX's) q / qmax
        dp = empty ? 0.0f : __fdiv_rn((float)(k >> a.idb), (float)a.qmax);
      }
      const size_t g = base + (size_t)r * wl + c;
      a.index[g] = ix;
      a.depth[g] = dp;
    }
  }
}

template <bool EXACT_IN, bool EXACT_POOL>
cudaError_t launch_pyramid(const PyramidArgs& a, cudaStream_t s) {
  const size_t key = EXACT_POOL ? 8 : 4;
  const size_t smem =
      a.levels > 1 ? key * a.tile_h * a.tile_w * 5 / 4 : 0;
  auto kernel = pyramid_kernel<EXACT_IN, EXACT_POOL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // 16-byte rows: every row of the key buffer and of level 0 starts on a
  // multiple of the vector when w is one (the wrapper aligns the bases)
  const int vec = a.w % (EXACT_IN ? 2 : 4) == 0;
  const dim3 grid((a.w + a.tile_w - 1) / a.tile_w,
                  (a.h + a.tile_h - 1) / a.tile_h, a.nviews);
  kernel<<<grid, kThreads, smem, s>>>(a, vec);
  return cudaGetLastError();
}

cudaError_t pyramid(const PyramidArgs& a, bool exact_in, bool exact_pool,
                    cudaStream_t s) {
  if (exact_in) {
    return exact_pool ? launch_pyramid<true, true>(a, s)
                      : launch_pyramid<true, false>(a, s);
  }
  return exact_pool ? launch_pyramid<false, true>(a, s)
                    : launch_pyramid<false, false>(a, s);
}

cudaError_t project(bool exact, const float* xyz, const float* mats, int n,
                    int b, int h, int w, int idb, int qmax, void* keys,
                    float* depth0, cudaStream_t s) {
  if (n <= 0 || b <= 0) return cudaGetLastError();
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (exact) {
    project_kernel<true><<<blocks, kThreads, 0, s>>>(xyz, mats, n, b, h, w,
                                                     0, 0, keys, nullptr);
  } else {
    project_kernel<false><<<blocks, kThreads, 0, s>>>(
        xyz, mats, n, b, h, w, idb, qmax, keys, depth0);
  }
  return cudaGetLastError();
}

__global__ void zbuffer_keys_kernel(const int* __restrict__ pix,
                                    const int* __restrict__ key, int n,
                                    int n_pixels, int* __restrict__ buf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t j = (size_t)blockIdx.y * n + i;
  const int p = pix[j];
  if (p < 0 || p >= n_pixels) return;
  atomicMin(buf + (size_t)blockIdx.y * n_pixels + p, key[j]);
}

}  // namespace

// K6: pix, key [b, n] int32; buf [b, n_pixels] int32 pre-filled with
// INT32_MAX. Returns cudaGetLastError() after the launch.
extern "C" int zbuffer_keys(const int* pix, const int* key, int n, int b,
                            int n_pixels, int* buf, void* stream) {
  if (n > 0 && b > 0) {
    dim3 grid((n + kThreads - 1) / kThreads, b);
    zbuffer_keys_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        pix, key, n, n_pixels, buf);
  }
  return (int)cudaGetLastError();
}

// K1: buf [B, h*w] int32 pre-filled with INT32_MAX; depth0 [B, n] float32.
// Returns cudaGetLastError() after the launch.
extern "C" int zbuffer_project(const float* xyz, const float* mats, int n,
                               int b, int h, int w, int idb, int qmax,
                               int* buf, float* depth0, void* stream) {
  return (int)project(false, xyz, mats, n, b, h, w, idb, qmax, buf, depth0,
                      (cudaStream_t)stream);
}

namespace {

// The fill, the projection (K1 or K5; the splat projection where splat
// is not null) and the pyramid pass, on one stream.
int fill_project_pyramid(const float* xyz, const float* mats, int n, int b,
                         int h, int w, int levels, int exact_in,
                         int exact_pool, int idb, int qmax, void* keys,
                         int* index, float* depth, const SplatArgs* splat,
                         cudaStream_t s) {
  const long long npx = (long long)b * h * w;
  if (npx <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(keys, 0xff, npx * (exact_in ? 8 : 4), s);
  if (err != cudaSuccess) return (int)err;
  if (splat == nullptr) {
    err = project(exact_in, xyz, mats, n, b, h, w, idb, qmax, keys, nullptr,
                  s);
  } else if (n > 0) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    if (exact_in) {
      splat_kernel<true><<<blocks, kThreads, 0, s>>>(xyz, mats, n, b, h, w,
                                                     0, 0, keys, *splat);
    } else {
      splat_kernel<false><<<blocks, kThreads, 0, s>>>(
          xyz, mats, n, b, h, w, idb, qmax, keys, *splat);
    }
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  const int span = 1 << (levels - 1);
  PyramidArgs a;
  a.keys = keys;
  a.xyz = xyz;
  a.mats = mats;
  a.nviews = b;
  a.h = h;
  a.w = w;
  a.levels = levels;
  a.tile_h = span > kTileH ? span : kTileH;
  a.tile_w = span > kTileW ? span : kTileW;
  a.idb = idb;
  a.qmax = qmax;
  a.index = index;
  a.depth = depth;
  return (int)pyramid(a, exact_in, exact_pool, s);
}

}  // namespace

// K1 (exact_in 0) or K5 (exact_in 1), then the pyramid pass, on one
// stream: keys [B, h*w] scratch (uint32 or uint64, 16-byte aligned,
// filled here with ~0); index and depth [total] 16-byte aligned, the
// levels one after another, level l [B, h >> l, w >> l]. h and w are
// multiples of 2^(levels - 1); levels <= 8. idb and qmax: the packed
// key's (K1's input or the packed pool). Returns the first CUDA error.
extern "C" int zbuffer_pyramid(const float* xyz, const float* mats, int n,
                               int b, int h, int w, int levels,
                               int exact_in, int exact_pool, int idb,
                               int qmax, void* keys, int* index,
                               float* depth, void* stream) {
  return fill_project_pyramid(xyz, mats, n, b, h, w, levels, exact_in,
                              exact_pool, idb, qmax, keys, index, depth,
                              nullptr, (cudaStream_t)stream);
}

// K6 on its user path: zbuffer_pyramid's contract with the splat
// projection in place of K1 (exact_in 0) or K5 (exact_in 1). radius in
// 1..16; sizes [N] float32 or null; relative: z-scaled sizes; thr: a host
// array of radius + 1 floats, thr[k] = float32(k - 1e-4).
extern "C" int zbuffer_splat_pyramid(const float* xyz, const float* mats,
                                     int n, int b, int h, int w, int levels,
                                     int exact_in, int exact_pool, int idb,
                                     int qmax, void* keys, int* index,
                                     float* depth, const float* sizes,
                                     int radius, int relative,
                                     float min_size, const float* thr,
                                     void* stream) {
  if (radius < 1 || radius > kMaxRadius) return (int)cudaErrorInvalidValue;
  SplatArgs sp;
  sp.sizes = sizes;
  sp.radius = radius;
  sp.varying = sizes != nullptr || relative != 0;
  sp.relative = relative;
  sp.min_size = min_size;
  for (int k = 0; k <= kMaxRadius; ++k) sp.thr[k] = k <= radius ? thr[k] : 0;
  return fill_project_pyramid(xyz, mats, n, b, h, w, levels, exact_in,
                              exact_pool, idb, qmax, keys, index, depth, &sp,
                              (cudaStream_t)stream);
}
