// The z-buffers for Hopper: K1 (projecting, packed int32 key), K5
// (projecting, exact 64-bit key) and K6 (given packed keys). K1 and K5
// share one projection, so they pick the same pixel for every point, bit
// for bit.
//
// K1 replaces read_tpu/ops/rasterize_pallas.py `_kernel2` (via
// `zbuffer_pallas2` / `zbuffer_scatter1_pallas`) together with the XLA
// projection and `pack_keys` that feed it (rasterize.py:81-131,
// rasterize_pallas.py:295-308). Per pixel it keeps the minimum of the
// packed int32 key `(q << idb) | id`, q = trunc(clip(depth * qmax, 0,
// qmax - 1)), over the points of one view; B views run in one launch.
//
// K5 replaces read_tpu/ops/rasterize_pallas.py `_kernel` (via
// `zbuffer_pallas` / `rasterize_pallas`), the exact z-buffer that
// rasterize.py's default 'sort' method (`_zbuffer_sort`) also computes:
// per pixel the least depth, ties to the least id. Its key is
// `(float bits of depth) << 32 | id` in 64 bits: a depth in [0, 1] is a
// non-negative float, and those order like their bit patterns, so the
// key's minimum is the (depth, id) lexicographic minimum, with no depth
// quantization and no limit on the number of points below 2^31. A second
// small kernel unpacks the keys into index (-1 empty) and exact depth
// (0 empty), so no depth is re-gathered.
//
// K6 replaces read_tpu/ops/rasterize_pallas.py `_kernel3` (via
// `zbuffer_pallas3`, and `_kernel2`'s contract on given keys): the
// per-pixel minimum of keys the caller packed, pix [N] or [B, N] -> [B,
// n_pixels], empty INT32_MAX. It is K1 without the fused projection: one
// thread per key, one atomicMin; a pix outside [0, n_pixels) returns at
// once (no dump slot). The TPU kernel's (8, 128)-tiled framebuffer, a
// layout for VMEM row read-modify-writes, has no use here. Bound: 8 bytes
// read per key and the atomics (the framebuffer stays in L2).
//
// What bounds them: memory. Each (view, point) reads 12 bytes of xyz,
// and at most one atomicMin lands in the framebuffer (K1 4 bytes, K5 8;
// 1.8 / 3.6 MB at 1216x368, L2-resident on a 50 MB L2).
//
// Design: one thread per (view, point) projects, packs and does
// `atomicMin` on a framebuffer filled with the empty sentinel. The TPU
// kernels walked the points in order on one core and needed a dump row
// (K1) or a scalar branch (K5) for invalid points; here min is
// order-independent, so the result is deterministic with no lock, and
// invalid points simply return (no dump slot: a million atomics on one
// address would serialize). The projection uses the _rn intrinsics so
// nvcc cannot contract the expanded product into FMAs: the result is
// bit-equal to the element-wise PyTorch twin, which keeps JAX's order
// ((m0*x + m1*y) + m2*z) + m3.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float row_dot(const float* r, float x, float y,
                                         float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r[0], x),
                                       __fmul_rn(r[1], y)),
                             __fmul_rn(r[2], z)),
                   r[3]);
}

// Projects point (x, y, z) by the row-major world->clip matrix m. Sets
// *depth to (ndc_z + 1) * 0.5 and returns true when the point lies in
// the clip cube; then sets *pix to its flat pixel id, or to -1 when its
// pixel falls outside the h x w frame.
__device__ __forceinline__ bool project_point(const float* m, float x,
                                              float y, float z, int h,
                                              int w, int* pix,
                                              float* depth) {
  const float cx = row_dot(m, x, y, z);
  const float cy = row_dot(m + 4, x, y, z);
  const float cz = row_dot(m + 8, x, y, z);
  const float cw = row_dot(m + 12, x, y, z);
  const float nx = __fdiv_rn(cx, cw);
  const float ny = __fdiv_rn(cy, cw);
  const float nz = __fdiv_rn(cz, cw);
  *depth = __fmul_rn(__fadd_rn(nz, 1.0f), 0.5f);
  // NaN fails every comparison, so a NaN coordinate is invalid, as in JAX
  if (!(fabsf(nx) <= 1.0f && fabsf(ny) <= 1.0f && fabsf(nz) <= 1.0f &&
        cw > 0.0f)) {
    return false;
  }
  // u = floor((w * (x + 1)) * 0.5), v = floor((h * (1 - y)) * 0.5)
  const int u = (int)floorf(
      __fmul_rn(__fmul_rn((float)w, __fadd_rn(nx, 1.0f)), 0.5f));
  const int v = (int)floorf(
      __fmul_rn(__fmul_rn((float)h, __fsub_rn(1.0f, ny)), 0.5f));
  *pix = (u < 0 || u >= w || v < 0 || v >= h) ? -1 : v * w + u;
  return true;
}

__global__ void zbuffer_project_kernel(const float* __restrict__ xyz,
                                       const float* __restrict__ mats,
                                       int n, int h, int w, int idb,
                                       int qmax, int* __restrict__ buf,
                                       float* __restrict__ depth0) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= n) return;
  int pix;
  float depth;
  const bool valid = project_point(mats + 16 * b, xyz[3 * i],
                                   xyz[3 * i + 1], xyz[3 * i + 2], h, w,
                                   &pix, &depth);
  depth0[(size_t)b * n + i] = valid ? depth : 0.0f;
  if (!valid || pix < 0) return;
  const float qf = fminf(fmaxf(__fmul_rn(depth, (float)qmax), 0.0f),
                         (float)(qmax - 1));
  const int key = ((int)qf << idb) | i;  // (int) truncates, as astype
  atomicMin(buf + (size_t)b * h * w + pix, key);
}

__global__ void zbuffer_exact_project_kernel(
    const float* __restrict__ xyz, const float* __restrict__ mats, int n,
    int h, int w, unsigned long long* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= n) return;
  int pix;
  float depth;
  if (!project_point(mats + 16 * b, xyz[3 * i], xyz[3 * i + 1],
                     xyz[3 * i + 2], h, w, &pix, &depth) ||
      pix < 0) {
    return;
  }
  const unsigned long long key =
      ((unsigned long long)__float_as_uint(depth) << 32) | (unsigned)i;
  atomicMin(keys + (size_t)b * h * w + pix, key);
}

__global__ void zbuffer_exact_unpack_kernel(
    const unsigned long long* __restrict__ keys, long long total,
    int* __restrict__ index, float* __restrict__ depth) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  const unsigned long long key = keys[j];
  const bool empty = key == ~0ull;
  index[j] = empty ? -1 : (int)(unsigned)(key & 0xffffffffull);
  depth[j] = empty ? 0.0f : __uint_as_float((unsigned)(key >> 32));
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

// buf [B, h*w] int32 pre-filled with INT32_MAX; depth0 [B, n] float32.
// Returns cudaGetLastError() after the launch.
extern "C" int zbuffer_project(const float* xyz, const float* mats, int n,
                               int b, int h, int w, int idb, int qmax,
                               int* buf, float* depth0, void* stream) {
  if (n > 0 && b > 0) {
    dim3 grid((n + kThreads - 1) / kThreads, b);
    zbuffer_project_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        xyz, mats, n, h, w, idb, qmax, buf, depth0);
  }
  return (int)cudaGetLastError();
}

// keys [B, h*w] uint64 scratch (filled here with the empty sentinel
// ~0); index [B, h*w] int32 and depth [B, h*w] float32 outputs.
// Returns cudaGetLastError() after the launches.
extern "C" int zbuffer_exact_project(const float* xyz, const float* mats,
                                     int n, int b, int h, int w,
                                     unsigned long long* keys, int* index,
                                     float* depth, void* stream) {
  const long long total = (long long)b * h * w;
  if (total <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(keys, 0xff, total * sizeof(*keys), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    dim3 grid((n + kThreads - 1) / kThreads, b);
    zbuffer_exact_project_kernel<<<grid, kThreads, 0, s>>>(xyz, mats, n, h,
                                                           w, keys);
  }
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  zbuffer_exact_unpack_kernel<<<blocks, kThreads, 0, s>>>(keys, total,
                                                          index, depth);
  return (int)cudaGetLastError();
}
