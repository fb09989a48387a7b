// The triangle raster for Hopper: one view of an indexed triangle mesh to
// its (face id, depth) maps, bit-equal to the plain PyTorch twin in
// read_tpu_torch/ops/rasterize_mesh.py (`_chunk_keys` and the
// `scatter_reduce_` amin over its keys).
//
// It replaces no TPU kernel: read_tpu/ops/rasterize_mesh.py
// `rasterize_mesh` (:84-162) is plain XLA, a sort of every candidate
// pixel. On the card the twin is a chain of ~110 element-wise launches a
// view over [T, samples, samples] arrays (49M candidates for the 0.77M
// faces of the benchmark's street at samples 8, ~195 MB each, written
// and read back), which took ~8.6 ms a raster (PERF.md). Yet a face
// needs only its three projected corners, its area and its subgrid's
// corner; the rest is arithmetic in registers and one atomic a covered
// pixel.
//
// What the twin computes, per face: the three vertices projected in JAX's
// order ((m0*x + m1*y) + m2*z) + m3, each clip coordinate divided by w;
// the face is valid where every w > 1e-9; its screen corners sx = (w_px *
// (x + 1)) * 0.5, sy = (h_px * (1 - y)) * 0.5; the signed area by the edge
// function (b - a) x (c - a), flat where |area| < 1e-12; the subgrid
// corner x0 = floor(min sx), y0 = floor(min sy). Per candidate pixel (x0 +
// gx, y0 + gy), gx, gy < samples, with centre (px + 0.5, py + 0.5): the
// three edge functions, inside where each times sign(area) is >= 0;
// barycentrics e0 / area, e1 / area and (1 - b0) - b1; z summed left to
// right; depth (z + 1) * 0.5; kept where inside, on the frame, |z| <= 1
// and depth >= 0, as K5's exact key (depth bits) << 32 | face id, the
// least per pixel winning (the least depth, ties to the least id).
//
// Bit-equality. Every rounding the twin makes is one PyTorch op, and
// each is made here once, in the same order, with the _rn intrinsics, so
// nvcc cannot contract a product and a sum into one FMA (-fmad is on by
// default; zbuffer.cu's projection does the same). Multiplying an edge
// value by sign(area) = +-1 is exact, so the test is e >= 0 or e <= 0 by
// the sign. The float -> int conversion of the floor is the twin's
// (cvt.rzi: saturating, NaN to 0). The acceptance and the accepted keys
// are what decide the maps, so a face or candidate that the twin would
// reject for certain is skipped early: an invalid vertex, a flat or NaN
// area (a NaN area makes every z NaN), a subgrid off the frame, and the
// candidates of the subgrid off the frame.
//
// What bounds it. Bytes: each face reads its 3 ids and 3 vertices (48
// bytes; the 13.8 MB of the street's mesh stay in the 50 MB L2 from one
// view to the next), and each accepted candidate does one 64-bit
// atomicMin into a key buffer of the view's pixels (0.5 MB at 256x256),
// which stays in L2. Operations: 3 projections a face (12 products, 12
// sums and 3 correctly rounded divisions each) whatever its fate, the
// edge tests of the subgrid's on-frame candidates, two divisions an
// inside candidate. On a crop most faces are off the frame and leave
// after their setup. Then the unpack writes the maps once.
//
// Design: one thread a face, its setup in registers, then its subgrid's
// on-frame candidates in a loop; the view's matrix read into shared memory
// once a block. The faces of a warp are neighbours on the mesh, so they
// mostly leave or loop together. (Sharing each passing face's candidates
// out over the warp's lanes, its corners broadcast by shuffles, took 62
// registers and was slower at every level of the benchmark's crops and
// at the frame: PERF.md.) Empty pixels keep the fill, ~0
// (unsigned, above every key: depths lie in [0, 1]); the unpack writes
// face id -1 and depth 0 there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kEmpty64 = ~0ull;

__device__ __forceinline__ float row_dot(const float* r, float x, float y,
                                         float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r[0], x),
                                       __fmul_rn(r[1], y)),
                             __fmul_rn(r[2], z)),
                   r[3]);
}

// The edge function (bx - ax) * (py - ay) - (by - ay) * (px - ax)
__device__ __forceinline__ float edge(float ax, float ay, float bx, float by,
                                      float px, float py) {
  return __fsub_rn(__fmul_rn(__fsub_rn(bx, ax), __fsub_rn(py, ay)),
                   __fmul_rn(__fsub_rn(by, ay), __fsub_rn(px, ax)));
}

// torch.amin: a NaN operand gives NaN
__device__ __forceinline__ float nan_min3(float a, float b, float c) {
  const float ab = (a < b || a != a) ? a : b;
  return (ab < c || ab != ab) ? ab : c;
}

// What the candidate loop needs of one face.
struct Face {
  float sx[3], sy[3], nz[3], area;
  int x0, y0, id;
};

// Face i's setup; false where the twin keeps none of its candidates.
__device__ __forceinline__ bool face_setup(const float* __restrict__ verts,
                                           int nv,
                                           const int* __restrict__ faces,
                                           int i, const float* m, int h,
                                           int w, int samples, Face* f) {
  bool valid = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int v = faces[3 * (size_t)i + k];
    if (v < 0) v += nv;   // a negative id counts from the end, as indexing
    // an id with no vertex (the twin's indexing raises): no candidate
    if (v < 0 || v >= nv) return false;
    const float x = verts[3 * (size_t)v];
    const float y = verts[3 * (size_t)v + 1];
    const float z = verts[3 * (size_t)v + 2];
    const float cw = row_dot(m + 12, x, y, z);
    valid = valid && cw > 1e-9f;
    const float nx = __fdiv_rn(row_dot(m, x, y, z), cw);
    const float ny = __fdiv_rn(row_dot(m + 4, x, y, z), cw);
    f->nz[k] = __fdiv_rn(row_dot(m + 8, x, y, z), cw);
    f->sx[k] = __fmul_rn(__fmul_rn((float)w, __fadd_rn(nx, 1.0f)), 0.5f);
    f->sy[k] = __fmul_rn(__fmul_rn((float)h, __fsub_rn(1.0f, ny)), 0.5f);
  }
  f->area = edge(f->sx[0], f->sy[0], f->sx[1], f->sy[1], f->sx[2], f->sy[2]);
  // flat, or NaN (every z of a NaN area is NaN)
  if (!valid || !(fabsf(f->area) >= 1e-12f)) return false;
  f->x0 = (int)floorf(nan_min3(f->sx[0], f->sx[1], f->sx[2]));
  f->y0 = (int)floorf(nan_min3(f->sy[0], f->sy[1], f->sy[2]));
  f->id = i;
  // the subgrid [x0, x0 + samples) x [y0, y0 + samples) meets the frame
  return (long long)f->x0 < w && (long long)f->x0 + samples > 0 &&
         (long long)f->y0 < h && (long long)f->y0 + samples > 0;
}

// Candidate (gx, gy) of face f: its key into keys where the twin keeps
// it. The candidate lies on the frame (the caller's range).
__device__ __forceinline__ void candidate(const Face& f, int gx, int gy,
                                          int w, unsigned long long* keys) {
  const int px = f.x0 + gx, py = f.y0 + gy;
  const float cx = __fadd_rn((float)px, 0.5f);
  const float cy = __fadd_rn((float)py, 0.5f);
  const float e0 = edge(f.sx[1], f.sy[1], f.sx[2], f.sy[2], cx, cy);
  const float e1 = edge(f.sx[2], f.sy[2], f.sx[0], f.sy[0], cx, cy);
  const float e2 = edge(f.sx[0], f.sy[0], f.sx[1], f.sy[1], cx, cy);
  // e * sign(area) >= 0, sign(area) = +-1 (a non-flat, non-NaN area)
  const bool inside = f.area > 0.0f
                          ? (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)
                          : (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
  if (!inside) return;
  const float b0 = __fdiv_rn(e0, f.area);
  const float b1 = __fdiv_rn(e1, f.area);
  const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
  const float z = __fadd_rn(__fadd_rn(__fmul_rn(b0, f.nz[0]),
                                      __fmul_rn(b1, f.nz[1])),
                            __fmul_rn(b2, f.nz[2]));
  const float depth = __fmul_rn(__fadd_rn(z, 1.0f), 0.5f);
  if (!(fabsf(z) <= 1.0f && depth >= 0.0f)) return;
  atomicMin(keys + (size_t)py * w + px,
            ((unsigned long long)__float_as_uint(depth) << 32) |
                (unsigned)f.id);
}

// One thread a face: its setup, then its subgrid's candidates on the
// frame, [gx0, gx1) x [gy0, gy1). keys [h*w] filled with ~0; mat the
// row-major world->clip matrix [16].
__global__ void __launch_bounds__(kThreads)
    raster_kernel(const float* __restrict__ verts, int nv,
                  const int* __restrict__ faces, int nf,
                  const float* __restrict__ mat, int h, int w, int samples,
                  unsigned long long* __restrict__ keys) {
  __shared__ float m[16];
  if (threadIdx.x < 16) m[threadIdx.x] = mat[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Face f;
  if (i >= nf || !face_setup(verts, nv, faces, i, m, h, w, samples, &f)) {
    return;
  }
  const int gx0 = max(0, -f.x0), gy0 = max(0, -f.y0);
  const int gx1 = (int)min((long long)samples, (long long)w - f.x0);
  const int gy1 = (int)min((long long)samples, (long long)h - f.y0);
  for (int gy = gy0; gy < gy1; ++gy) {
    for (int gx = gx0; gx < gx1; ++gx) candidate(f, gx, gy, w, keys);
  }
}

// keys [n] -> index [n] (-1 where empty) and depth [n] (0 where empty)
__global__ void __launch_bounds__(kThreads)
    unpack_kernel(const unsigned long long* __restrict__ keys, int n,
                  int* __restrict__ index, float* __restrict__ depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long k = keys[i];
  const bool empty = k == kEmpty64;
  index[i] = empty ? -1 : (int)(unsigned)(k & 0xffffffffull);
  depth[i] = empty ? 0.0f : __uint_as_float((unsigned)(k >> 32));
}

}  // namespace

// One view: verts [nv, 3] float32, faces [nf, 3] int32 vertex ids (nf <
// 2^31), mat [4, 4] float32 on the device, keys [h*w] uint64 scratch,
// index [h*w] int32 and depth [h*w] float32 out. The fill, the raster and
// the unpack on one stream. Returns the first CUDA error.
extern "C" int mesh_raster(const float* verts, int nv, const int* faces,
                           int nf, const float* mat, int h, int w,
                           int samples, void* keys, int* index, float* depth,
                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long npx = (long long)h * w;
  if (npx <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(keys, 0xff, npx * 8, s);
  if (err != cudaSuccess) return (int)err;
  if (nf > 0 && samples > 0) {
    raster_kernel<<<(unsigned)((nf + kThreads - 1) / kThreads), kThreads, 0,
                    s>>>(verts, nv, faces, nf, mat, h, w, samples,
                         (unsigned long long*)keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  unpack_kernel<<<(unsigned)((npx + kThreads - 1) / kThreads), kThreads, 0,
                  s>>>((const unsigned long long*)keys, (int)npx, index,
                       depth);
  return (int)cudaGetLastError();
}
