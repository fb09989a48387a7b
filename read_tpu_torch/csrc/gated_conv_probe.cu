// K8: the phase probe of K2, for Hopper.
//
// Replaces scripts/probe_pack_split.py `variant_kernel` (:33-69), which
// strips phases off the TPU's pack9 kernel to bound what each costs. Here
// it strips them off K2's own loops, on a 3x3, stride-1, zero-padded conv
// x [B, H, W, Cin] * w [3, 3, Cin, 2*Cout], with each phase kept or
// stripped by MODE:
//   0 full      staging + multiply; out [B, H, W, 2*Cout] = the raw sums
//               (f columns then m columns, no bias, no epilogue);
//   1 nopack    the multiply over shared memory never filled: time only;
//   2 packonly  staging alone; out[p, j] = the staged tap value of K index
//               j (tap-major (ky, kx, ci), im2col order) for j < 2*Cout;
//   3 nowin     as full with every tap reading the centre pixel (no halo
//               staging), masked where the shifted tap leaves the image.
// The differences between the modes' times bound staging vs multiply.
//
// Two loops (`loop`), chosen by the caller (ops/gated_conv_probe.py routes
// as K2's `kxk_route` does):
// - wgmma: K2's warp-specialized wgmma loop (gated_conv_wgmma.cuh,
//   template argument PROBE; its note says what each mode strips), with
//   the packed weight of `pack_kxk_bf16` (bf16 operands) or
//   `pack_kxk_tf32` (f32 operands as three TF32 products), where K2 runs
//   79 of a frame's 84 calls. packonly's out is the staged operand: bf16
//   widened, or the sum hi + lo of the TF32 parts the f32 consumer splits
//   it into;
// - tile: the tile loops K2 keeps for its other calls (gated_conv_tile.cuh,
//   the f32 SIMT tile and the bf16 WMMA tile) with the HWIO weight.
//
// What bounds it: what bounds the loop (tensor-core rate or the stages in
// flight, PERF.md), less the gated epilogue; packonly is bound by the
// staging's loads and shared stores.

#include <type_traits>

#include "gated_conv_tile.cuh"
#include "gated_conv_wgmma.cuh"

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
int run_tile(const ConvArgs& a, bool vec4, cudaStream_t s) {
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

// K2's wgmma loop in probe mode PROBE, in the operand mode
template <int PROBE>
int run_wgmma(const gcw::Args& a, bool bf16, cudaStream_t s) {
  const int tile_n = gcw::tile_n_for(a.Cout);
  return bf16 ? gcw::checked_launch<false, false, PROBE>(a, tile_n, s)
              : gcw::checked_launch<true, false, PROBE>(a, tile_n, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

enum { kLoopTile = 0, kLoopWgmma = 1 };

}  // namespace

// out [B, H, W, 2*Cout] float32 (mode 2: columns from 9*Cin on
// zero-filled by the caller). loop = kLoopTile: w is the HWIO weight
// [3, 3, Cin, 2*Cout] f32, bf16 rounds both operands. loop = kLoopWgmma:
// w is `pack_kxk_bf16` (bf16 = 1) or `pack_kxk_tf32` (bf16 = 0) of the
// weight, at the tile width `wgmma_tile_n` gives; the loop's own checks
// (gcw::checked_launch) and a 16-byte aligned out, else
// cudaErrorInvalidValue.
extern "C" int gated_conv_probe(const float* x, const void* w, float* out,
                                int B, int H, int W, int Cin, int Cout,
                                int mode, int bf16, int loop, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode < gc::kFull || mode > gc::kNoWin ||
      (loop != kLoopTile && loop != kLoopWgmma))
    return (int)cudaErrorInvalidValue;
  if (loop == kLoopWgmma) {
    const int ks = bf16 ? gcw::BK : gcw::TF32_BK;  // K a slice
    const int tn2 = gcw::tile_n_for(Cout) / 2;     // channels an N tile
    gcw::Args a{x, static_cast<const uint8_t*>(w), nullptr, nullptr,
                nullptr, nullptr, out, B, H, W, Cin, H, W, Cout, 3, 1, 1, 0,
                9 * Cin, (9 * Cin + ks - 1) / ks, (Cout + tn2 - 1) / tn2};
    if (!aligned16(out)) return (int)cudaErrorInvalidValue;
    switch (mode) {  // PROBE = mode + 1 (kProduction is 0)
      case gc::kFull: return run_wgmma<gcw::kProbeFull>(a, bf16, s);
      case gc::kNoPack: return run_wgmma<gcw::kProbeNoPack>(a, bf16, s);
      case gc::kPackOnly: return run_wgmma<gcw::kProbePackOnly>(a, bf16, s);
      default: return run_wgmma<gcw::kProbeNoWin>(a, bf16, s);
    }
  }
  ConvArgs a{x, static_cast<const float*>(w), nullptr, nullptr, nullptr,
             nullptr, out, B, H, W, Cin, H, W, Cout, 3, 1, 1, 0, bf16};
  if (B * H * W == 0 || Cout == 0) return (int)cudaGetLastError();
  const bool vec4 = aligned16(x);
  switch (mode) {
    case gc::kFull: return run_tile<gc::kFull>(a, vec4, s);
    case gc::kNoPack: return run_tile<gc::kNoPack>(a, vec4, s);
    case gc::kPackOnly: return run_tile<gc::kPackOnly>(a, vec4, s);
    default: return run_tile<gc::kNoWin>(a, vec4, s);
  }
}
