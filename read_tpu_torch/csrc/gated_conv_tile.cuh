// The tile loops of the gated-conv implicit GEMM (K2, K3, K4), shared with
// the K2 phase probe (K8, gated_conv_probe.cu) so that the probe times the
// very staging and multiply code the kernels run.
//
// A block owns a BM-pixel x BN-channel output tile and walks K = k*k*Cin
// (tap-major, then channel) in slices: each slice's input patch (zero
// outside the image) and the matching rows of the f and m weight columns
// are staged in shared memory, then multiplied into register (f32 SIMT,
// fma_tile) or WMMA (bf16 tensor cores, tc_tile) accumulators of BOTH f
// and m, so the gated epilogue sees a pixel's f and m together. What a
// tile loop does at the end is the caller's Store functor:
// Store::operator()(args, f_sum, m_sum, pixel, channel).
//
// The template parameter MODE strips phases for the probe; the kernels
// use kFull, which compiles to the loop alone:
//   kFull     staging and the multiply loop;
//   kNoPack   the multiply loop over shared memory that is never filled
//             (timing only: it reads whatever shared memory holds); the
//             staging code stays behind a branch never taken at run time,
//             so the compiler allocates registers as for kFull;
//   kPackOnly staging alone; the staged input values that fall on this
//             block's output columns are written to out[p, K index]
//             (only slices that meet those columns pay for the write);
//   kNoWin    every tap stages the centre pixel (no halo reads), masked
//             where the shifted tap would leave the image.
// Src reads the input: PlainSrc one NHWC tensor, CatSrc the logical
// channel concat of up to kMaxCat [n, C_j] tensors (K4).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace gc {

struct ConvArgs {
  const float* x;       // [B, H, W, Cin] (unused by CatSrc)
  const float* w;       // [k, k, Cin, C2]; C2 = 2*Cout gated, else Cout
  const float* bias;    // [C2]
  const float* scale;   // [Cout]
  const float* offset;  // [Cout]
  const float* res;     // [B, Ho, Wo, Cout] or nullptr
  float* out;           // [B, Ho, Wo, Cout] (the probe: [.., 2*Cout])
  int B, H, W, Cin, Ho, Wo, Cout, k, stride, pad, relu, bf16;
};

enum { kFull = 0, kNoPack = 1, kPackOnly = 2, kNoWin = 3 };

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct PlainSrc {
  __device__ __forceinline__ float load1(const ConvArgs& a, size_t pix,
                                         int ci) const {
    return a.x[pix * a.Cin + ci];
  }
  __device__ __forceinline__ float4 load4(const ConvArgs& a, size_t pix,
                                          int c) const {
    return *reinterpret_cast<const float4*>(a.x + pix * a.Cin + c);
  }
};

constexpr int kMaxCat = 4;

struct CatSrc {
  const float* x[kMaxCat];
  int off[kMaxCat + 1];  // first channel of input j; off[n] = sum C_j
  int n;

  // input j holding concat channel ci, its base pointer and width
  __device__ __forceinline__ const float* at(int ci, int* j0,
                                             int* cj) const {
    const float* p = x[0];
    int o = 0, c = off[1];
#pragma unroll
    for (int t = 1; t < kMaxCat; ++t) {
      if (t < n && ci >= off[t]) {
        p = x[t];
        o = off[t];
        c = off[t + 1] - off[t];
      }
    }
    *j0 = o;
    *cj = c;
    return p;
  }
  __device__ __forceinline__ float load1(const ConvArgs&, size_t pix,
                                         int ci) const {
    int o, c;
    const float* p = at(ci, &o, &c);
    return p[pix * c + ci - o];
  }
  // c is a multiple of 4 and every C_j too, so 4 channels share an input
  __device__ __forceinline__ float4 load4(const ConvArgs&, size_t pix,
                                          int ci) const {
    int o, c;
    const float* p = at(ci, &o, &c);
    return *reinterpret_cast<const float4*>(p + pix * c + ci - o);
  }
};

// The gated epilogue for output pixel p, channel c from the raw sums:
// bias, ELU(f) * sigmoid(m) (GATED) or act(f), folded BN, residual.
template <bool GATED>
struct GateStore {
  __device__ __forceinline__ void operator()(const ConvArgs& a, float f,
                                             float g, int p, int c) const {
    f += a.bias[c];
    float o;
    if (GATED) {
      g += a.bias[a.Cout + c];
      if (a.relu) f = f > 0.0f ? f : expm1f(f);
      o = f * (1.0f / (1.0f + expf(-g)));
    } else {
      o = a.relu ? (f > 0.0f ? f : expm1f(f)) : f;
    }
    o = o * a.scale[c] + a.offset[c];
    const size_t oi = (size_t)p * a.Cout + c;
    if (a.res != nullptr) o += a.res[oi];
    a.out[oi] = o;
  }
};

// The probe's output: the raw sums, f at channel c, m at Cout + c.
struct RawStore {
  __device__ __forceinline__ void operator()(const ConvArgs& a, float f,
                                             float g, int p, int c) const {
    const size_t oi = (size_t)p * 2 * a.Cout;
    a.out[oi + c] = f;
    a.out[oi + a.Cout + c] = g;
  }
};

// kPackOnly writes nothing at the end: its output is the staged taps.
struct NoStore {
  __device__ __forceinline__ void operator()(const ConvArgs&, float, float,
                                             int, int) const {}
};

// kPackOnly: the staged value of K index kidx at pixel p goes to
// out[p, kidx] when kidx is one of this block's output columns
// (f: [n0, n0 + bn), m: Cout + [n0, n0 + bn), both below 2*Cout).
__device__ __forceinline__ void write_staged(const ConvArgs& a, int p,
                                             int kidx, int n0, int bn,
                                             float v) {
  const bool f_col = kidx >= n0 && kidx < n0 + bn && kidx < a.Cout;
  const int km = kidx - a.Cout;
  const bool m_col = km >= n0 && km < n0 + bn && km >= 0 && km < a.Cout;
  if (f_col || m_col) a.out[(size_t)p * 2 * a.Cout + kidx] = v;
}

// Whether K indices [row0, row0 + depth) meet this block's output
// columns (kPackOnly writes only those).
__device__ __forceinline__ bool slice_hits(const ConvArgs& a, int row0,
                                           int depth, int n0, int bn) {
  const int end = row0 + depth;
  return (row0 < n0 + bn && end > n0) ||
         (row0 < a.Cout + n0 + bn && end > a.Cout + n0);
}

constexpr int BK = 8;

// f32 SIMT tile: BM x BN outputs of f (and m when GATED), BK-deep slices;
// each thread accumulates a TM x TN register tile. bf16 rounds both
// operands as they are staged.
template <int BM, int BN, int TM, int TN, int MODE, bool GATED, class Src,
          class Store>
__device__ __forceinline__ void fma_tile(const ConvArgs& a, const Src& src,
                                         const Store& store) {
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
  const int c2 = GATED ? 2 * a.Cout : a.Cout;

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
        const int row0 = (ky * a.k + kx) * a.Cin + c0;
        if (MODE != kNoPack || a.k < 0) {
          const int ci = c0 + kk_a;
#pragma unroll
          for (int i = 0; i < A_PER; ++i) {
            const int iy = iy0[i] + ky, ix = ix0[i] + kx;
            float v = 0.0f;
            if (img[i] >= 0 && ci < a.Cin && iy >= 0 && iy < a.H &&
                ix >= 0 && ix < a.W) {
              v = MODE == kNoWin
                      ? src.load1(a, (size_t)(img[i] + iy0[i] + a.pad) *
                                             a.W + ix0[i] + a.pad, ci)
                      : src.load1(a, (size_t)(img[i] + iy) * a.W + ix, ci);
            }
            As[kk_a][i * ROWS + tid / BK] = a.bf16 ? round_bf16(v) : v;
          }
          for (int e = tid; e < BK * BN; e += NT) {
            const int kk = e / BN, nn = e % BN, col = n0 + nn;
            float f = 0.0f, g = 0.0f;
            if (col < a.Cout && c0 + kk < a.Cin) {
              const float* wr = a.w + (size_t)(row0 + kk) * c2;
              f = wr[col];
              if (GATED) g = wr[a.Cout + col];
            }
            Bf[kk][nn] = a.bf16 ? round_bf16(f) : f;
            if (GATED) Bm[kk][nn] = a.bf16 ? round_bf16(g) : g;
          }
        }
        __syncthreads();
        if (MODE == kPackOnly) {
          if (slice_hits(a, row0, BK, n0, BN)) {
            for (int e = tid; e < BK * BM; e += NT) {  // kk fastest
              const int kk = e % BK, mm = e / BK, p = m0 + mm;
              if (p < npix && c0 + kk < a.Cin)
                write_staged(a, p, row0 + kk, n0, BN, As[kk][mm]);
            }
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < BK; ++kk) {
            float av[TM], fv[TN], gv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              fv[j] = Bf[kk][tx * TN + j];
              if (GATED) gv[j] = Bm[kk][tx * TN + j];
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) {
                accf[i][j] = fmaf(av[i], fv[j], accf[i][j]);
                if (GATED) accm[i][j] = fmaf(av[i], gv[j], accm[i][j]);
              }
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
      if (c < a.Cout) store(a, accf[i][j], accm[i][j], p, c);
    }
  }
}

// Tensor-core tile for bf16 operands with Cin % 32 == 0 and 16-byte
// aligned rows (every conv of the UNet but the three on the 8-channel
// descriptor inputs): 16x16x16 bf16 WMMA tiles (mma.sync underneath) with
// f32 accumulators. Each 128-pixel x 32-channel block stages a 128 x 32
// input slice and the 32 x (32 f | 32 m) weight slice in shared memory as
// bf16; 8 warps each own 32 pixels x 32 columns (2 x 2 fragments, f or
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

template <int MODE, class Src, class Store>
__device__ __forceinline__ void tc_tile(const ConvArgs& a, const Src& src,
                                        const Store& store) {
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
        const int row0 = (ky * a.k + kx) * a.Cin + c0;
        if (MODE != kNoPack || a.k < 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int iy = iy0[i] + ky, ix = ix0[i] + kx;
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (img[i] >= 0 && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
              v = MODE == kNoWin
                      ? src.load4(a, (size_t)(img[i] + iy0[i] + a.pad) *
                                             a.W + ix0[i] + a.pad,
                                  c0 + 4 * q)
                      : src.load4(a, (size_t)(img[i] + iy) * a.W + ix,
                                  c0 + 4 * q);
            __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
                As + (tid / 8 + 32 * i) * tc::LDA + 4 * q);
            dst[0] = __floats2bfloat162_rn(v.x, v.y);
            dst[1] = __floats2bfloat162_rn(v.z, v.w);
          }
          for (int e = tid; e < tc::BKT * 2 * tc::BN; e += tc::THREADS) {
            const int kk = e / (2 * tc::BN), nn = e % (2 * tc::BN);
            const int ch = n0 + nn % tc::BN;
            float v = 0.0f;
            if (ch < a.Cout)
              v = a.w[(size_t)(row0 + kk) * c2 +
                      (nn < tc::BN ? ch : a.Cout + ch)];
            Bs[kk * tc::LDB + nn] = __float2bfloat16_rn(v);
          }
        }
        __syncthreads();
        if (MODE == kPackOnly) {
          if (slice_hits(a, row0, tc::BKT, n0, tc::BN)) {
            for (int e = tid; e < tc::BKT * tc::BM; e += tc::THREADS) {
              const int kk = e % tc::BKT, mm = e / tc::BKT, p = m0 + mm;
              if (p < npix)
                write_staged(a, p, row0 + kk, n0, tc::BN,
                             __bfloat162float(As[mm * tc::LDA + kk]));
            }
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < tc::BKT; ks += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fa[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fb[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              wmma::load_matrix_sync(fa[i],
                                     As + (wrow + 16 * i) * tc::LDA + ks,
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
        }
        __syncthreads();
      }
    }
  }

  if constexpr (MODE != kPackOnly) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            Cs + (wrow + 16 * i) * tc::LDC + wcol + 16 * j, acc[i][j],
            tc::LDC, wmma::mem_row_major);
    __syncthreads();
    const int c = tid % tc::BN;
    if (n0 + c >= a.Cout) return;
    for (int r = tid / tc::BN; r < tc::BM; r += tc::THREADS / tc::BN) {
      const int p = m0 + r;
      if (p < npix)
        store(a, Cs[r * tc::LDC + c], Cs[r * tc::LDC + tc::BN + c], p,
              n0 + c);
    }
  }
}

}  // namespace gc
