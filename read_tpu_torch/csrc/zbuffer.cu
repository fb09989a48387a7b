// K1: projecting packed-key z-buffer (scatter1 semantics), for Hopper.
//
// Replaces read_tpu/ops/rasterize_pallas.py `_kernel2` (via
// `zbuffer_pallas2` / `zbuffer_scatter1_pallas`) together with the XLA
// projection and `pack_keys` that feed it (rasterize.py:81-131,
// rasterize_pallas.py:295-308). Per pixel it keeps the minimum of the
// packed int32 key `(q << idb) | id`, q = trunc(clip(depth * qmax, 0,
// qmax - 1)), over the points of one view; B views run in one launch.
//
// What bounds it: memory. Each (view, point) reads 12 bytes of xyz and
// writes 4 bytes of depth, and at most one 4-byte atomicMin lands in the
// framebuffer (1.8 MB at 1216x368, L2-resident on a 50 MB L2).
//
// Design: one thread per (view, point) projects, packs and does
// `atomicMin` on the int32 framebuffer the wrapper pre-fills with
// INT32_MAX. The TPU kernel walked the points in order on one core and
// needed a dump row for invalid points to stay branch-free; here min is
// order-independent, so the result is deterministic with no lock, and
// invalid points simply return (no dump slot: a million atomics on one
// address would serialize). The projection uses the _rn intrinsics so
// nvcc cannot contract the expanded product into FMAs: the result is
// bit-equal to the element-wise PyTorch twin, which keeps JAX's order
// ((m0*x + m1*y) + m2*z) + m3.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float row_dot(const float* r, float x, float y,
                                         float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r[0], x),
                                       __fmul_rn(r[1], y)),
                             __fmul_rn(r[2], z)),
                   r[3]);
}

__global__ void zbuffer_project_kernel(const float* __restrict__ xyz,
                                       const float* __restrict__ mats,
                                       int n, int h, int w, int idb,
                                       int qmax, int* __restrict__ buf,
                                       float* __restrict__ depth0) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= n) return;
  const float* m = mats + 16 * b;
  const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
  const float cx = row_dot(m, x, y, z);
  const float cy = row_dot(m + 4, x, y, z);
  const float cz = row_dot(m + 8, x, y, z);
  const float cw = row_dot(m + 12, x, y, z);
  const float nx = __fdiv_rn(cx, cw);
  const float ny = __fdiv_rn(cy, cw);
  const float nz = __fdiv_rn(cz, cw);
  // NaN fails every comparison, so a NaN coordinate is invalid, as in JAX
  const bool valid = fabsf(nx) <= 1.0f && fabsf(ny) <= 1.0f &&
                     fabsf(nz) <= 1.0f && cw > 0.0f;
  const float depth = __fmul_rn(__fadd_rn(nz, 1.0f), 0.5f);
  depth0[(size_t)b * n + i] = valid ? depth : 0.0f;
  if (!valid) return;
  // u = floor((w * (x + 1)) * 0.5), v = floor((h * (1 - y)) * 0.5)
  const int u = (int)floorf(
      __fmul_rn(__fmul_rn((float)w, __fadd_rn(nx, 1.0f)), 0.5f));
  const int v = (int)floorf(
      __fmul_rn(__fmul_rn((float)h, __fsub_rn(1.0f, ny)), 0.5f));
  if (u < 0 || u >= w || v < 0 || v >= h) return;
  const float qf = fminf(fmaxf(__fmul_rn(depth, (float)qmax), 0.0f),
                         (float)(qmax - 1));
  const int key = ((int)qf << idb) | i;  // (int) truncates, as astype
  atomicMin(buf + (size_t)b * h * w + (size_t)v * w + u, key);
}

}  // namespace

// buf [B, h*w] int32 pre-filled with INT32_MAX; depth0 [B, n] float32.
// Returns cudaGetLastError() after the launch.
extern "C" int zbuffer_project(const float* xyz, const float* mats, int n,
                               int b, int h, int w, int idb, int qmax,
                               int* buf, float* depth0, void* stream) {
  if (n > 0 && b > 0) {
    const int threads = 256;
    dim3 grid((n + threads - 1) / threads, b);
    zbuffer_project_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        xyz, mats, n, h, w, idb, qmax, buf, depth0);
  }
  return (int)cudaGetLastError();
}
