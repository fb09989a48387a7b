"""K7's wgmma route on the CPU: the route, the packed weights, the
``packed`` getter, and the arithmetic of the loops' bf16-storage mode.

``r2_route`` is checked over gated or not, Cin 8/32/64, Cout 12/32, both
dtypes and both kernel sizes, and against misaligned x and bias views;
``pack_r2`` of bf16 HWIO weights is held bit for bit against the weight
by a plain inverse of the block layout (unswizzle, f|m interleave), so
the f32 round trip loses nothing; a ``packed`` getter that raises is
never called on the CPU (the twin runs). A plain emulation of what the
bf16-storage loop computes from ``pack_r2`` (bf16 x and weights as
stored, per N tile one product summed in f32, f and m read from the
accumulator columns ``16q + r`` and ``16q + 8 + r``, the f32 epilogue,
one round to bf16) is held against ``scripts/gated_conv_pallas_r2.py``
(interpret mode, bf16 in and out) at K = 9 x 256 = 2304 and 256 within
``atol 1e-3, rtol 1e-2``: both sum the same bf16 products in f32 and
round once, so they differ by at most one bf16 ulp.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu_torch.ops import gated_conv as GC
from read_tpu_torch.ops import gated_conv_r2 as R2

BF16_OUT = dict(atol=1e-3, rtol=1e-2)
_SPEC = importlib.util.spec_from_file_location(
    "gated_conv_pallas_r2", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts", "gated_conv_pallas_r2.py"))
G = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(G)


def _case(rng, h, w, cin, cout, k, gated=True, dtype=torch.float32):
    c2 = 2 * cout if gated else cout
    x = torch.from_numpy(rng.normal(size=(h, w, cin)).astype(np.float32))
    wk = torch.from_numpy((rng.normal(size=(k, k, cin, c2))
                           / np.sqrt(k * k * cin)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=c2) * 0.1).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
    offset = torch.from_numpy((rng.normal(size=cout) * 0.1).astype(
        np.float32))
    return x.to(dtype), wk.to(dtype), b, scale, offset


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [12, 32])
@pytest.mark.parametrize("cin", [8, 32, 64])
@pytest.mark.parametrize("gated", [True, False])
def test_route_takes_gated_aligned_widths_to_the_loops(gated, cin, cout,
                                                       dtype, k):
    x, wk, b, scale, offset = _case(np.random.default_rng(cin + cout), 3, 5,
                                    cin, cout, k, gated, dtype)
    want = "wgmma" if (gated and cout % 8 == 0
                       and cin % (32 if k == 3 else 8) == 0) else "band"
    assert R2.r2_route(x, wk, gated, (b, scale, offset)) == want
    if k == 1:   # a [Cin, C2] weight routes as its [1, 1, Cin, C2] form
        assert R2.r2_route(x, wk[0, 0], gated, (b, scale, offset)) == want


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_keeps_misaligned_views_on_the_band_kernel(k, dtype):
    x, wk, b, scale, offset = _case(np.random.default_rng(k), 3, 5, 32, 32,
                                    k, True, dtype)
    assert R2.r2_route(x, wk, True, (b, scale, offset)) == "wgmma"
    flat = torch.zeros(x.numel() + 1, dtype=dtype)
    xv = flat[1:].view(x.shape)          # 2 or 4 bytes past x's alignment
    assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
    assert R2.r2_route(xv, wk, True, (b, scale, offset)) == "band"
    bv = torch.zeros(b.numel() + 1)[1:]   # 4 bytes past 8
    assert R2.r2_route(x, wk, True, (bv, scale, offset)) == "band"


def _unswizzle(packed):
    """Undo the 128-byte swizzle: row n's 16-byte chunk j sits at j ^ (n %
    8)."""
    *lead, tn, row = packed.shape
    blocks = packed.float().reshape(*lead, tn, 8, row // 8)
    src = torch.arange(8)[None, :] ^ (torch.arange(tn)[:, None] % 8)
    idx = src[:, :, None].expand(tn, 8, row // 8)
    return torch.gather(blocks, -2, idx.expand_as(blocks)).reshape(
        *lead, tn, row)


def _columns(nt, tn, cout):
    """For the packed columns (tile t, row n): the weight column each
    holds (f: channel c, m: Cout + c), -1 where none."""
    n = torch.arange(nt * tn)
    g = (n % tn) // 8
    ch = (n // tn) * (tn // 2) + 8 * (g // 2) + n % 8
    return torch.where(ch < cout, ch + cout * (g % 2), -1)


def _bmat(packed):
    """Blocks ``[nt, s, tn, row]`` -> the K x (nt * tn) matrix they
    hold."""
    nt, s, tn, row = packed.shape
    return _unswizzle(packed).permute(1, 3, 0, 2).reshape(s * row, nt * tn)


@pytest.mark.parametrize("shape", [(3, 3, 32, 64), (3, 3, 64, 192),
                                   (1, 1, 8, 64), (1, 1, 256, 512)])
def test_pack_of_bf16_weights_is_lossless(shape):
    k, _, cin, c2 = shape
    rng = np.random.default_rng(cin + c2)
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)
    packed = R2.pack_r2(w)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    kk = k * k * cin
    kmat = _bmat(packed)
    cols = _columns(packed.shape[0], packed.shape[2], c2 // 2)
    got = torch.full((kmat.shape[0], c2), float("nan"))
    got[:, cols[cols >= 0]] = kmat[:, cols >= 0]
    assert torch.equal(got[:kk], w.float().reshape(kk, c2))
    assert not bool(got[kk:].any()) and not bool(kmat[:, cols < 0].any())
    # and the f32 route's pack is the TF32 split of the f32 weight
    wf = w.float()
    want = GC.pack_kxk_tf32(wf) if k == 3 else GC.pack_1x1_tf32(wf)
    assert torch.equal(R2.pack_r2(wf), want)


@pytest.mark.parametrize("k", [3, 1])
def test_packed_getter_is_never_called_on_the_cpu(k):
    x, wk, b, scale, offset = _case(np.random.default_rng(5), 4, 6, 32, 32,
                                    k, True, torch.bfloat16)

    def never():
        raise AssertionError("the packed getter ran on the CPU")

    kern, twin = ((R2.gated_conv3x3_r2, R2.gated_conv3x3_r2_plain)
                  if k == 3 else
                  (R2.gated_conv1x1_r2, R2.gated_conv1x1_r2_plain))
    before = dict(R2.launches)
    got = kern(x, wk, b, scale, offset, packed=never)
    assert R2.launches == before
    assert torch.equal(got, twin(x, wk, b, scale, offset))


def _emulate_bf16_storage(x, packed, b, scale, offset, k, relu=True):
    """What the bf16-storage loop computes for one image: the patch
    (tap-major K, zero-padded to the slices) of bf16 ``x`` as stored, one
    f32 product per N tile against the unswizzled bf16 blocks; f =
    column 16q + r and m = column 16q + 8 + r of each tile for channel
    tile*tn/2 + 8q + r; the f32 epilogue; one round to bf16."""
    h, wd, cin = x.shape
    nt, s, tn, row = packed.shape
    cout = scale.shape[0]
    pad = (k - 1) // 2
    xp = torch.nn.functional.pad(x.float(), (0, 0, pad, pad, pad, pad))
    a = torch.cat([xp[ky:ky + h, kx:kx + wd] for ky in range(k)
                   for kx in range(k)], -1).reshape(h * wd, k * k * cin)
    a = torch.nn.functional.pad(a, (0, s * row - k * k * cin))
    acc = (a @ _bmat(packed)).reshape(-1, nt, tn // 16, 2, 8)
    f = acc[:, :, :, 0].reshape(h * wd, -1)[:, :cout]
    m = acc[:, :, :, 1].reshape(h * wd, -1)[:, :cout]
    fm = torch.cat([f, m], -1).reshape(h, wd, 2 * cout)
    return GC.gated_epilogue(fm, b, scale, offset, None, relu).to(
        torch.bfloat16)


@pytest.mark.parametrize("k", [3, 1])
def test_bf16_storage_arithmetic_matches_pallas(k):
    """At Cin = 256 (K = 2304 for 3x3) and Cout = 96 (two N tiles of 64
    channels, the second half empty) on a 6x7 image."""
    rng = np.random.default_rng(11 + k)
    x, wk, b, scale, offset = _case(rng, 6, 7, 256, 96, k, True,
                                    torch.bfloat16)
    got = _emulate_bf16_storage(x, R2.pack_r2(wk), b, scale, offset, k)
    fn = G.gated_conv3x3 if k == 3 else G.gated_conv1x1
    want = fn(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
              *map(jnp.asarray, (wk.float().numpy(), b.numpy(),
                                 scale.numpy(), offset.numpy())),
              relu=True, gated=True, tile_h=4, interpret=True)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **BF16_OUT)
    # the twin agrees as well: same products, f32 sums, one rounding
    twin = (R2.gated_conv3x3_r2_plain if k == 3
            else R2.gated_conv1x1_r2_plain)
    torch.testing.assert_close(got.float(), twin(x, wk, b, scale,
                                                 offset).float(), **BF16_OUT)
