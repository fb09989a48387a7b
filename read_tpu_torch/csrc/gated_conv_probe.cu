// K8: the phase probe of K2, for Hopper.
//
// Replaces scripts/probe_pack_split.py `variant_kernel` (:33-69), which
// strips phases off the TPU's pack9 kernel to bound what each costs. Here
// it runs K2's own tile loops (gated_conv_tile.cuh, the f32 SIMT tile and
// the bf16 WMMA tile, picked exactly as K2 picks them) on a 3x3, stride-1,
// zero-padded conv x [B, H, W, Cin] * w [3, 3, Cin, 2*Cout], with each
// phase kept or stripped by MODE:
//   0 full      staging + multiply; out [B, H, W, 2*Cout] = the raw sums
//               (f columns then m columns, no bias, no epilogue);
//   1 nopack    the multiply over shared memory never filled: time only;
//   2 packonly  staging alone; out[p, j] = the staged tap value of K index
//               j (tap-major (ky, kx, ci), im2col order) for j < 2*Cout;
//   3 nowin     as full with every tap reading the centre pixel (no halo
//               staging), masked where the shifted tap leaves the image.
// The differences between the modes' times bound staging vs multiply.
//
// What bounds it: what bounds K2 (FMA or tensor-core rate), less the
// epilogue; packonly is bound by the shared-memory stores of staging.

#include <type_traits>

#include "gated_conv_tile.cuh"

namespace {

using gc::ConvArgs;

template <int MODE>
using ProbeStore =
    typename std::conditional<MODE == gc::kPackOnly, gc::NoStore,
                              gc::RawStore>::type;

template <int BM, int BN, int TM, int TN, int MODE>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
probe_kernel(const ConvArgs a) {
  gc::fma_tile<BM, BN, TM, TN, MODE, true>(a, gc::PlainSrc(),
                                           ProbeStore<MODE>());
}

template <int MODE>
__global__ void __launch_bounds__(gc::tc::THREADS)
probe_tc_kernel(const ConvArgs a) {
  gc::tc_tile<MODE>(a, gc::PlainSrc(), ProbeStore<MODE>());
}

template <int BM, int BN, int TM, int TN, int MODE>
void launch(const ConvArgs& a, cudaStream_t s) {
  const int npix = a.B * a.Ho * a.Wo;
  dim3 grid((npix + BM - 1) / BM, (a.Cout + BN - 1) / BN);
  probe_kernel<BM, BN, TM, TN, MODE><<<grid, (BM / TM) * (BN / TN), 0, s>>>(
      a);
}

template <int MODE>
int run(const ConvArgs& a, bool vec4, cudaStream_t s) {
  const int npix = a.B * a.Ho * a.Wo;
  if (a.bf16 && a.Cin % gc::tc::BKT == 0 && vec4) {
    dim3 grid((npix + gc::tc::BM - 1) / gc::tc::BM,
              (a.Cout + gc::tc::BN - 1) / gc::tc::BN);
    probe_tc_kernel<MODE><<<grid, gc::tc::THREADS, 0, s>>>(a);
  } else if (a.Cout <= 16) {
    launch<128, 16, 8, 2, MODE>(a, s);
  } else if (a.Cout <= 32) {
    launch<128, 32, 8, 4, MODE>(a, s);
  } else {
    launch<128, 64, 8, 8, MODE>(a, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out [B, H, W, 2*Cout] float32 (mode 2: zero-filled by the caller).
extern "C" int gated_conv_probe(const float* x, const float* w, float* out,
                                int B, int H, int W, int Cin, int Cout,
                                int mode, int bf16, void* stream) {
  ConvArgs a{x, w, nullptr, nullptr, nullptr, nullptr, out,
             B, H, W, Cin, H, W, Cout, 3, 1, 1, 0, bf16};
  cudaStream_t s = (cudaStream_t)stream;
  if (B * H * W == 0 || Cout == 0) return (int)cudaGetLastError();
  const bool vec4 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  switch (mode) {
    case gc::kFull: return run<gc::kFull>(a, vec4, s);
    case gc::kNoPack: return run<gc::kNoPack>(a, vec4, s);
    case gc::kPackOnly: return run<gc::kPackOnly>(a, vec4, s);
    case gc::kNoWin: return run<gc::kNoWin>(a, vec4, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
