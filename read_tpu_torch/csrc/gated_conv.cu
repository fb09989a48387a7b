// K2, K3 and K4: fused gated convolutions of the MIMO-UNet, for Hopper.
//
// K2 `gated_conv_kxk` replaces read_tpu/ops/gated_conv_pack.py
// `_conv3x3_chw_dot3_kernel` (and its pack9 twin `_conv3x3_chw_kernel`)
// via `gated_conv3x3_chw`, plus the space-to-depth / im2col routes
// read_tpu/models/unet_pallas.py `_Ctx.conv` (:178-219) takes for the
// strided transitions: k in {3, 4}, stride in {1, 2}, zero pad (k-1)/2.
// K3 `gated_conv_1x1` replaces `_conv1x1_chw_kernel` via
// `gated_conv1x1_chw` (the SCM 1x1 BasicConvs).
// K4 `gated_conv_1x1_cat` replaces `_conv1x1_cat_kernel` via
// `gated_conv1x1_cat_chw`: K3 over the logical channel concat of up to 4
// inputs [n, C_j], sum_j x_j @ W[rows of j], the concat never written.
//
// All compute, per output pixel p and channel c < Cout,
//   f = sum_t x[p, t] * w[t, c]        + bias[c]
//   m = sum_t x[p, t] * w[t, Cout + c] + bias[Cout + c]
//   out = (relu ? elu(f) : f) * sigmoid(m) * scale[c] + offset[c] (+ res)
// with activations NHWC float32 and weights flax HWIO [k, k, Cin, 2*Cout]
// (the fused [f | m] halves); K4 with gated = 0 drops m and the sigmoid
// (weights [Ctot, Cout]). `bf16` rounds both operands to bfloat16 (round
// to nearest even, as jnp.astype) and keeps the float32 sum: a product
// of two bf16 values is exact in f32, so this is JAX's bf16-operand /
// f32-accumulate `bf16_mxu` arithmetic.
//
// What bounds them: arithmetic. At full width the UNet does ~16 GFLOP per
// 3x3 conv (K = 9*Cin, N = 2*Cout) against a few hundred MB of
// activations, far above the card's bytes-per-FLOP line; K4 at its SCM
// shapes (K = 72..256) too. With f32 operands the CUDA cores' FMA rate
// bounds them (exact f32 has no tensor core path; TF32 would change the
// numbers); with bf16 operands the tensor cores do: K2's bf16 calls with
// Cin % 32 == 0 and Cout % 8 == 0 run the warp-specialized wgmma loop of
// gated_conv_wgmma.cuh (`gated_conv_kxk_wgmma`, its own note), the rest
// mma.sync through WMMA here.
//
// Design: an implicit GEMM, M = output pixels, N = output channels, K =
// k*k*Cin, with no im2col buffer in device memory; the TPU kernels' lane
// packing, halo BlockSpecs and space-to-depth weights are not needed:
// strides and padding are index arithmetic here. The tile loops live in
// gated_conv_tile.cuh (shared with the K8 phase probe): a block owns a
// BM x BN output tile, stages each K slice of the input patch (zero
// outside the image) and of the f and m weight columns in shared memory,
// and accumulates BOTH f and m (f32: SIMT register tiles; bf16 with
// Cin % 32 == 0: WMMA), so the gated epilogue (bias, ELU * sigmoid, BN
// affine, residual) runs before the single output write. K4 is the same
// loop with the A loads walking the inputs' pointers (CatSrc): a K slice
// may straddle two inputs, each element finds its own.

#include "gated_conv_tile.cuh"
#include "gated_conv_wgmma.cuh"

namespace {

using gc::ConvArgs;

template <int BM, int BN, int TM, int TN, bool GATED, class Src>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gated_conv_kernel(const ConvArgs a, const Src src) {
  gc::fma_tile<BM, BN, TM, TN, gc::kFull, GATED>(a, src,
                                                 gc::GateStore<GATED>());
}

template <class Src>
__global__ void __launch_bounds__(gc::tc::THREADS)
gated_conv_tc_kernel(const ConvArgs a, const Src src) {
  gc::tc_tile<gc::kFull>(a, src, gc::GateStore<true>());
}

template <int BM, int BN, int TM, int TN, bool GATED, class Src>
int launch(const ConvArgs& a, const Src& src, cudaStream_t stream) {
  const int npix = a.B * a.Ho * a.Wo;
  dim3 grid((npix + BM - 1) / BM, (a.Cout + BN - 1) / BN);
  gated_conv_kernel<BM, BN, TM, TN, GATED, Src>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(a, src);
  return (int)cudaGetLastError();
}

// vec4: the input rows are 16-byte aligned float4 runs (tensor-core route)
template <bool GATED, class Src>
int dispatch(const ConvArgs& a, const Src& src, bool vec4, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int npix = a.B * a.Ho * a.Wo;
  if (npix == 0 || a.Cout == 0) return (int)cudaGetLastError();
  if (GATED && a.bf16 && a.Cin % gc::tc::BKT == 0 && vec4) {
    dim3 grid((npix + gc::tc::BM - 1) / gc::tc::BM,
              (a.Cout + gc::tc::BN - 1) / gc::tc::BN);
    gated_conv_tc_kernel<Src><<<grid, gc::tc::THREADS, 0, s>>>(a, src);
    return (int)cudaGetLastError();
  }
  if (a.Cout <= 16) return launch<128, 16, 8, 2, GATED>(a, src, s);
  if (a.Cout <= 32) return launch<128, 32, 8, 4, GATED>(a, src, s);
  return launch<128, 64, 8, 8, GATED>(a, src, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
  return dispatch<true>(a, gc::PlainSrc(), aligned16(x), stream);
}

// K2 with bf16 operands on the wgmma loop (gated_conv_wgmma.cuh). wp is
// the packed weight of ops/gated_conv.py `pack_kxk_bf16`: ntiles N tiles of
// tile_n columns (64 or 128), each ceil(k*k*Cin / 64) blocks of
// [tile_n, 64] bf16. Returns the error of setting the shared-memory size,
// of the occupancy query or of the launch (cudaErrorInvalidValue for
// arguments the loop does not take).
extern "C" int gated_conv_kxk_wgmma(const float* x, const void* wp,
                                    const float* bias, const float* scale,
                                    const float* offset, const float* res,
                                    float* out, int B, int H, int W,
                                    int Cin, int Cout, int k, int stride,
                                    int relu, int tile_n, int ntiles,
                                    void* stream) {
  const int pad = (k - 1) / 2;
  gcw::Args a{x, static_cast<const uint8_t*>(wp), bias, scale, offset,
              res, out, B, H, W, Cin,
              (H + 2 * pad - k) / stride + 1, (W + 2 * pad - k) / stride + 1,
              Cout, k, stride, pad, relu, k * k * Cin,
              (k * k * Cin + gcw::BK - 1) / gcw::BK, ntiles};
  if (Cin % 32 != 0 || Cout % 8 != 0 || !aligned16(x) || !aligned16(wp) ||
      (tile_n != 64 && tile_n != 128) ||
      ntiles != (Cout + tile_n / 2 - 1) / (tile_n / 2))
    return (int)cudaErrorInvalidValue;
  if (B * a.Ho * a.Wo == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return tile_n == 64 ? gcw::launch<64>(a, s) : gcw::launch<128>(a, s);
}

// K3: 1x1 conv over n pixels, i.e. [n, Cin] @ [Cin, 2*Cout] + epilogue.
extern "C" int gated_conv_1x1(const float* x, const float* w,
                              const float* bias, const float* scale,
                              const float* offset, const float* res,
                              float* out, int n, int Cin, int Cout,
                              int relu, int bf16, void* stream) {
  ConvArgs a{x, w, bias, scale, offset, res, out,
             1, 1, n, Cin, 1, n, Cout, 1, 1, 0, relu, bf16};
  return dispatch<true>(a, gc::PlainSrc(), aligned16(x), stream);
}

// K4: 1x1 conv over n pixels of the channel concat of nx <= 4 inputs
// x_j [n, c_j] (unused pointers may be null); w [sum c_j, C2].
extern "C" int gated_conv_1x1_cat(const float* x0, const float* x1,
                                  const float* x2, const float* x3, int c0,
                                  int c1, int c2, int c3, int nx,
                                  const float* w, const float* bias,
                                  const float* scale, const float* offset,
                                  const float* res, float* out, int n,
                                  int Cout, int relu, int gated, int bf16,
                                  void* stream) {
  if (nx < 1 || nx > gc::kMaxCat) return (int)cudaErrorInvalidValue;
  gc::CatSrc src;
  const float* xs[gc::kMaxCat] = {x0, x1, x2, x3};
  const int cs[gc::kMaxCat] = {c0, c1, c2, c3};
  bool vec4 = true;
  src.n = nx;
  src.off[0] = 0;
  for (int j = 0; j < gc::kMaxCat; ++j) {
    src.x[j] = j < nx ? xs[j] : xs[0];
    src.off[j + 1] = src.off[j] + (j < nx ? cs[j] : 0);
    if (j < nx) vec4 = vec4 && cs[j] % 4 == 0 && aligned16(xs[j]);
  }
  ConvArgs a{nullptr, w, bias, scale, offset, res, out,
             1, 1, n, src.off[gc::kMaxCat], 1, n, Cout, 1, 1, 0, relu,
             bf16};
  return gated ? dispatch<true>(a, src, vec4, stream)
               : dispatch<false>(a, src, vec4, stream);
}
