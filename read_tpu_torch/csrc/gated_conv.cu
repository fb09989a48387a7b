// K2 and K3: fused gated convolutions of the MIMO-UNet, for Hopper.
//
// K2 `gated_conv_kxk` replaces read_tpu/ops/gated_conv_pack.py
// `_conv3x3_chw_dot3_kernel` (and its pack9 twin `_conv3x3_chw_kernel`)
// via `gated_conv3x3_chw`, plus the space-to-depth / im2col routes
// read_tpu/models/unet_pallas.py `_Ctx.conv` (:178-219) takes for the
// strided transitions: k in {3, 4}, stride in {1, 2}, zero pad (k-1)/2.
// K3 `gated_conv_1x1` replaces `_conv1x1_chw_kernel` via
// `gated_conv1x1_chw` (the SCM 1x1 BasicConvs).
//
// Both compute, per output pixel p and channel c < Cout,
//   f = sum_t x[p, t] * w[t, c]        + bias[c]
//   m = sum_t x[p, t] * w[t, Cout + c] + bias[Cout + c]
//   out = (relu ? elu(f) : f) * sigmoid(m) * scale[c] + offset[c] (+ res)
// with activations NHWC float32 and weights flax HWIO [k, k, Cin, 2*Cout]
// (the fused [f | m] halves). `bf16` rounds both operands to bfloat16
// (round to nearest even, as jnp.astype) and keeps the float32 sum: a
// product of two bf16 values is exact in f32, so this is JAX's
// bf16-operand / f32-accumulate `bf16_mxu` arithmetic.
//
// What bounds it: arithmetic. At full width the UNet does ~16 GFLOP per
// 3x3 conv (K = 9*Cin, N = 2*Cout) against a few hundred MB of
// activations, far above the card's bytes-per-FLOP line. With f32
// operands the CUDA cores' FMA rate bounds it (exact f32 has no tensor
// core path; TF32 would change the numbers); with bf16 operands the
// tensor cores do, through mma.sync here (no wgmma/TMA yet: later work).
//
// Design: an implicit GEMM, M = output pixels, N = output channels, K =
// k*k*Cin, with no im2col buffer in device memory; the TPU kernels' lane
// packing, halo BlockSpecs and space-to-depth weights are not needed:
// strides and padding are index arithmetic here. f32 (gated_conv_kernel):
// a block owns a BM x BN output tile and walks K in BK = 8 slices: the
// input patch slice (BM pixels x 8 channels of one tap, zero outside the
// image) and the two weight slices (f and m columns of the same BN
// channels) go to shared memory, then each thread accumulates a TM x TN
// register tile of BOTH f and m, so the gated epilogue (bias, ELU *
// sigmoid, BN affine, residual) runs in registers before the single
// output write. bf16 with Cin % 32 == 0: gated_conv_tc_kernel below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

struct ConvArgs {
  const float* x;       // [B, H, W, Cin]
  const float* w;       // [k, k, Cin, 2*Cout]
  const float* bias;    // [2*Cout]
  const float* scale;   // [Cout]
  const float* offset;  // [Cout]
  const float* res;     // [B, Ho, Wo, Cout] or nullptr
  float* out;           // [B, Ho, Wo, Cout]
  int B, H, W, Cin, Ho, Wo, Cout, k, stride, pad, relu, bf16;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The gated epilogue for output pixel p, channel c from the raw sums.
__device__ __forceinline__ void gate_store(const ConvArgs& a, float f,
                                           float g, int p, int c) {
  f += a.bias[c];
  g += a.bias[a.Cout + c];
  if (a.relu) f = f > 0.0f ? f : expm1f(f);
  float o = f * (1.0f / (1.0f + expf(-g)));
  o = o * a.scale[c] + a.offset[c];
  const size_t oi = (size_t)p * a.Cout + c;
  if (a.res != nullptr) o += a.res[oi];
  a.out[oi] = o;
}

constexpr int BK = 8;

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gated_conv_kernel(const ConvArgs a) {
  constexpr int NTX = BN / TN;          // threads along channels
  constexpr int NT = (BM / TM) * NTX;   // threads per block
  constexpr int ROWS = NT / BK;         // pixels loaded per pass
  constexpr int A_PER = BM / ROWS;      // input elements per thread
  static_assert(NT % BK == 0 && BM % ROWS == 0, "tile shape");
  __shared__ __align__(16) float As[BK][BM + 4];  // +4: no bank clash
  __shared__ __align__(16) float Bf[BK][BN];
  __shared__ __align__(16) float Bm[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % NTX, ty = tid / NTX;
  const int npix = a.B * a.Ho * a.Wo;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int c2 = 2 * a.Cout;

  // this thread always loads channel kk_a of pixels (i*ROWS + tid/BK)
  const int kk_a = tid % BK;
  int img[A_PER], iy0[A_PER], ix0[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int p = m0 + i * ROWS + tid / BK;
    if (p < npix) {
      const int b = p / (a.Ho * a.Wo);
      const int r = p - b * a.Ho * a.Wo;
      const int oy = r / a.Wo;
      const int ox = r - oy * a.Wo;
      img[i] = b * a.H;
      iy0[i] = oy * a.stride - a.pad;
      ix0[i] = ox * a.stride - a.pad;
    } else {
      img[i] = -1;
      iy0[i] = 0;
      ix0[i] = 0;
    }
  }

  float accf[TM][TN], accm[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accf[i][j] = accm[i][j] = 0.0f;

  for (int ky = 0; ky < a.k; ++ky) {
    for (int kx = 0; kx < a.k; ++kx) {
      for (int c0 = 0; c0 < a.Cin; c0 += BK) {
        const int ci = c0 + kk_a;
#pragma unroll
        for (int i = 0; i < A_PER; ++i) {
          const int iy = iy0[i] + ky, ix = ix0[i] + kx;
          float v = 0.0f;
          if (img[i] >= 0 && ci < a.Cin && iy >= 0 && iy < a.H &&
              ix >= 0 && ix < a.W)
            v = a.x[((size_t)(img[i] + iy) * a.W + ix) * a.Cin + ci];
          As[kk_a][i * ROWS + tid / BK] = a.bf16 ? round_bf16(v) : v;
        }
        const int row0 = (ky * a.k + kx) * a.Cin + c0;
        for (int e = tid; e < BK * BN; e += NT) {
          const int kk = e / BN, nn = e % BN, col = n0 + nn;
          float f = 0.0f, g = 0.0f;
          if (col < a.Cout && c0 + kk < a.Cin) {
            const float* wr = a.w + (size_t)(row0 + kk) * c2;
            f = wr[col];
            g = wr[a.Cout + col];
          }
          Bf[kk][nn] = a.bf16 ? round_bf16(f) : f;
          Bm[kk][nn] = a.bf16 ? round_bf16(g) : g;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float av[TM], fv[TN], gv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            fv[j] = Bf[kk][tx * TN + j];
            gv[j] = Bm[kk][tx * TN + j];
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              accf[i][j] = fmaf(av[i], fv[j], accf[i][j]);
              accm[i][j] = fmaf(av[i], gv[j], accm[i][j]);
            }
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = m0 + ty * TM + i;
    if (p >= npix) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c < a.Cout) gate_store(a, accf[i][j], accm[i][j], p, c);
    }
  }
}

// Tensor-core variant for bf16 operands with Cin % 32 == 0 (every conv of
// the UNet but the three on the 8-channel descriptor inputs): the same
// implicit GEMM with 16x16x16 bf16 WMMA tiles (mma.sync underneath) and
// f32 accumulators. Each 128-pixel x 32-channel block stages a 128 x 32
// input slice and the 32 x (32 f | 32 m) weight slice in shared memory
// as bf16; 8 warps each own 32 pixels x 32 columns (2 x 2 fragments, f or
// m). The accumulators go back through shared memory so that one thread
// sees both f and m of its (pixel, channel) for the gated epilogue.
namespace tc {
constexpr int BM = 128, BN = 32, BKT = 32, THREADS = 256;
constexpr int LDA = BKT + 8;         // bf16 elements per staged A row
constexpr int LDB = 2 * BN + 8;      // bf16 elements per staged B row
constexpr int LDC = 2 * BN + 4;      // floats per staged C row
constexpr int SMEM_AB = (BM * LDA + BKT * LDB) * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;
}  // namespace tc

__global__ void __launch_bounds__(tc::THREADS)
gated_conv_tc_kernel(const ConvArgs a) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[tc::SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + tc::BM * tc::LDA;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x, warp = tid / 32;
  const int npix = a.B * a.Ho * a.Wo;
  const int m0 = blockIdx.x * tc::BM;
  const int n0 = blockIdx.y * tc::BN;
  const int c2 = 2 * a.Cout;

  // A loads: this thread moves channels [4q, 4q + 4) of the slice for
  // pixels tid/8 + 32*i, as one float4 each
  const int q = tid % 8;
  int img[4], iy0[4], ix0[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = m0 + tid / 8 + 32 * i;
    if (p < npix) {
      const int b = p / (a.Ho * a.Wo);
      const int r = p - b * a.Ho * a.Wo;
      const int oy = r / a.Wo;
      const int ox = r - oy * a.Wo;
      img[i] = b * a.H;
      iy0[i] = oy * a.stride - a.pad;
      ix0[i] = ox * a.stride - a.pad;
    } else {
      img[i] = -1;
      iy0[i] = 0;
      ix0[i] = 0;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const int wrow = (warp % 4) * 32;  // warp's pixel rows in the tile
  const int wcol = (warp / 4) * 32;  // 0: f columns, 32: m columns

  for (int ky = 0; ky < a.k; ++ky) {
    for (int kx = 0; kx < a.k; ++kx) {
      for (int c0 = 0; c0 < a.Cin; c0 += tc::BKT) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int iy = iy0[i] + ky, ix = ix0[i] + kx;
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (img[i] >= 0 && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
            v = *reinterpret_cast<const float4*>(
                a.x + ((size_t)(img[i] + iy) * a.W + ix) * a.Cin + c0 +
                4 * q);
          __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
              As + (tid / 8 + 32 * i) * tc::LDA + 4 * q);
          dst[0] = __floats2bfloat162_rn(v.x, v.y);
          dst[1] = __floats2bfloat162_rn(v.z, v.w);
        }
        const int row0 = (ky * a.k + kx) * a.Cin + c0;
        for (int e = tid; e < tc::BKT * 2 * tc::BN; e += tc::THREADS) {
          const int kk = e / (2 * tc::BN), nn = e % (2 * tc::BN);
          const int ch = n0 + nn % tc::BN;
          float v = 0.0f;
          if (ch < a.Cout)
            v = a.w[(size_t)(row0 + kk) * c2 +
                    (nn < tc::BN ? ch : a.Cout + ch)];
          Bs[kk * tc::LDB + nn] = __float2bfloat16_rn(v);
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < tc::BKT; ks += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[i], As + (wrow + 16 * i) * tc::LDA + ks,
                                   tc::LDA);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(fb[j], Bs + ks * tc::LDB + wcol + 16 * j,
                                   tc::LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wrow + 16 * i) * tc::LDC + wcol + 16 * j,
                              acc[i][j], tc::LDC, wmma::mem_row_major);
  __syncthreads();
  const int c = tid % tc::BN;
  if (n0 + c >= a.Cout) return;
  for (int r = tid / tc::BN; r < tc::BM; r += tc::THREADS / tc::BN) {
    const int p = m0 + r;
    if (p < npix)
      gate_store(a, Cs[r * tc::LDC + c], Cs[r * tc::LDC + tc::BN + c], p,
                 n0 + c);
  }
}

template <int BM, int BN, int TM, int TN>
int launch(const ConvArgs& a, cudaStream_t stream) {
  const int npix = a.B * a.Ho * a.Wo;
  dim3 grid((npix + BM - 1) / BM, (a.Cout + BN - 1) / BN);
  gated_conv_kernel<BM, BN, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(const ConvArgs& a, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int npix = a.B * a.Ho * a.Wo;
  if (npix == 0 || a.Cout == 0) return (int)cudaGetLastError();
  if (a.bf16 && a.Cin % tc::BKT == 0 &&
      reinterpret_cast<uintptr_t>(a.x) % 16 == 0) {
    dim3 grid((npix + tc::BM - 1) / tc::BM, (a.Cout + tc::BN - 1) / tc::BN);
    gated_conv_tc_kernel<<<grid, tc::THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  if (a.Cout <= 16) return launch<128, 16, 8, 2>(a, s);
  if (a.Cout <= 32) return launch<128, 32, 8, 4>(a, s);
  return launch<128, 64, 8, 8>(a, s);
}

}  // namespace

// K2: k x k conv, stride `stride`, zero pad (k-1)/2 on each side.
extern "C" int gated_conv_kxk(const float* x, const float* w,
                              const float* bias, const float* scale,
                              const float* offset, const float* res,
                              float* out, int B, int H, int W, int Cin,
                              int Cout, int k, int stride, int relu,
                              int bf16, void* stream) {
  const int pad = (k - 1) / 2;
  ConvArgs a{x, w, bias, scale, offset, res, out,
             B, H, W, Cin,
             (H + 2 * pad - k) / stride + 1, (W + 2 * pad - k) / stride + 1,
             Cout, k, stride, pad, relu, bf16};
  return dispatch(a, stream);
}

// K3: 1x1 conv over n pixels, i.e. [n, Cin] @ [Cin, 2*Cout] + epilogue.
extern "C" int gated_conv_1x1(const float* x, const float* w,
                              const float* bias, const float* scale,
                              const float* offset, const float* res,
                              float* out, int n, int Cin, int Cout,
                              int relu, int bf16, void* stream) {
  ConvArgs a{x, w, bias, scale, offset, res, out,
             1, 1, n, Cin, 1, n, Cout, 1, 1, 0, relu, bf16};
  return dispatch(a, stream);
}
