// K7: the row-band gated 3x3 and 1x1 convolutions, for Hopper.
//
// Replaces scripts/gated_conv_pallas_r2.py `_conv3x3_kernel` (via
// `gated_conv3x3`) and `_conv1x1_kernel` (via `gated_conv1x1`), the
// round-2 design that K2 superseded on the TPU; it is kept as a second
// conv design at K2's shapes. Contract: one image x [H, W, Cin], weights
// HWIO [k, k, Cin, C2], stride 1, zero pad (k-1)/2, no residual; gated:
// C2 = 2*Cout, out = act(f) * sigmoid(m) * scale + offset; not gated:
// C2 = Cout, out = act(acc) * scale + offset; act = ELU when relu. T is
// float or bfloat16 for x, w and out alike (the input's dtype decides, as
// in the script); bias, scale and offset are float32; every sum is f32.
//
// What bounds it: arithmetic, as K2 (FMA rate: both forms multiply in
// f32 on the CUDA cores, the bf16 form only moves half the bytes).
//
// Design (unlike K2's implicit GEMM over pixel tiles): a block owns a
// band of TH output rows x TW columns x BN output channels (f and m). For
// each Cin chunk of CC channels it stages the (TH + k - 1) x (TW + k - 1)
// x CC input window once (zero outside the image) and the chunk's k*k
// weight rows, then each thread contracts the k dy rows over (dx, ci)
// from that one window: for a (dy, ci) it loads TM + k - 1 window values
// once and reuses them for all k dx taps. The gate, the folded BN and the
// store run in registers. Chunking Cin keeps the window small at any Cin
// (the whole 10 x 66 x 256 f32 window of one 64-wide band would need
// 675 KB, past the 227 KB a block can have).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 32, BN = 32, CC = 8, TM = 8, TN = 4;
constexpr int THREADS = (TH * TW / TM) * (BN / TN);  // 256

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int KS, bool GATED, typename T>
__global__ void __launch_bounds__(THREADS)
conv_r2_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias,
               const float* __restrict__ scale,
               const float* __restrict__ offset, T* __restrict__ out,
               int H, int W, int Cin, int Cout, int relu) {
  constexpr int WH = TH + KS - 1, WW = TW + KS - 1;
  constexpr int LDX = CC + 1;        // floats per window pixel: no clash
  constexpr int NW = GATED ? 2 : 1;  // weight column groups (f, m)
  constexpr int NA = TM + KS - 1;    // window values per (dy, ci)
  __shared__ float win[WH * WW * LDX];
  __shared__ __align__(16) float ws[KS * KS * CC][NW * BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int r = ty / (TW / TM);            // output row in the band
  const int xq = (ty % (TW / TM)) * TM;    // first output column
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int n0 = blockIdx.z * BN;
  const int pad = (KS - 1) / 2;
  const int c2 = GATED ? 2 * Cout : Cout;

  float accf[TM][TN], accm[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accf[i][j] = accm[i][j] = 0.0f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    for (int e = tid; e < WH * WW * CC; e += THREADS) {
      const int ci = e % CC, pix = e / CC;
      const int iy = y0 + pix / WW - pad, ix = x0 + pix % WW - pad;
      float v = 0.0f;
      if (c0 + ci < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = ld(x + ((size_t)iy * W + ix) * Cin + c0 + ci);
      win[pix * LDX + ci] = v;
    }
    for (int e = tid; e < KS * KS * CC * NW * BN; e += THREADS) {
      const int col = e % (NW * BN), kr = e / (NW * BN);
      const int ci = kr % CC, tap = kr / CC, ch = n0 + col % BN;
      float v = 0.0f;
      if (ch < Cout && c0 + ci < Cin)
        v = ld(w + ((size_t)tap * Cin + c0 + ci) * c2 +
               (col < BN ? ch : Cout + ch));
      ws[kr][col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int dy = 0; dy < KS; ++dy) {
#pragma unroll 2
      for (int ci = 0; ci < CC; ++ci) {
        float av[NA];
#pragma unroll
        for (int i = 0; i < NA; ++i)
          av[i] = win[((r + dy) * WW + xq + i) * LDX + ci];
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          const int kr = (dy * KS + dx) * CC + ci;
          const float4 f4 =
              *reinterpret_cast<const float4*>(&ws[kr][tx * TN]);
          const float fv[TN] = {f4.x, f4.y, f4.z, f4.w};
          float gv[TN] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (GATED) {
            const float4 g4 =
                *reinterpret_cast<const float4*>(&ws[kr][BN + tx * TN]);
            gv[0] = g4.x;
            gv[1] = g4.y;
            gv[2] = g4.z;
            gv[3] = g4.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              accf[i][j] = fmaf(av[i + dx], fv[j], accf[i][j]);
              if (GATED) accm[i][j] = fmaf(av[i + dx], gv[j], accm[i][j]);
            }
        }
      }
    }
    __syncthreads();
  }

  const int y = y0 + r;
  if (y >= H) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int xo = x0 + xq + i;
    if (xo >= W) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c >= Cout) continue;
      float f = accf[i][j] + bias[c], o;
      if (GATED) {
        const float g = accm[i][j] + bias[Cout + c];
        if (relu) f = f > 0.0f ? f : expm1f(f);
        o = f * (1.0f / (1.0f + expf(-g)));
      } else {
        o = relu ? (f > 0.0f ? f : expm1f(f)) : f;
      }
      st(out + ((size_t)y * W + xo) * Cout + c, o * scale[c] + offset[c]);
    }
  }
}

template <int KS, typename T>
int launch(const void* x, const void* w, const float* bias,
           const float* scale, const float* offset, void* out, int H, int W,
           int Cin, int Cout, int relu, int gated, void* stream) {
  if (H == 0 || W == 0 || Cout == 0) return (int)cudaGetLastError();
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, (Cout + BN - 1) / BN);
  cudaStream_t s = (cudaStream_t)stream;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (gated)
    conv_r2_kernel<KS, true, T><<<grid, THREADS, 0, s>>>(
        xt, wt, bias, scale, offset, ot, H, W, Cin, Cout, relu);
  else
    conv_r2_kernel<KS, false, T><<<grid, THREADS, 0, s>>>(
        xt, wt, bias, scale, offset, ot, H, W, Cin, Cout, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// k in {1, 3}; bf16: x, w and out are bfloat16, else float32.
extern "C" int gated_conv_r2(const void* x, const void* w, const float* bias,
                             const float* scale, const float* offset,
                             void* out, int H, int W, int Cin, int Cout,
                             int k, int relu, int gated, int bf16,
                             void* stream) {
  if (k == 3)
    return bf16 ? launch<3, __nv_bfloat16>(x, w, bias, scale, offset, out, H,
                                           W, Cin, Cout, relu, gated, stream)
                : launch<3, float>(x, w, bias, scale, offset, out, H, W, Cin,
                                   Cout, relu, gated, stream);
  if (k == 1)
    return bf16 ? launch<1, __nv_bfloat16>(x, w, bias, scale, offset, out, H,
                                           W, Cin, Cout, relu, gated, stream)
                : launch<1, float>(x, w, bias, scale, offset, out, H, W, Cin,
                                   Cout, relu, gated, stream);
  return (int)cudaErrorInvalidValue;
}
