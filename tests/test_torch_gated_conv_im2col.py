"""The f32 wgmma loop's A operand on the CPU: the TMA im2col copies' host
parameters and the consumer's register-A fragment reads.

``ops.gated_conv.im2col_copy_params`` (box, corners, traversal strides,
per-slice channel and tap offsets, each tile's start, and the walk they
define) are held against a numpy im2col at every call
of a full-width 1216x368 ``UNet()`` frame that ``kxk_route`` sends to the
wgmma loop (recorded at 16x32 with a shim: widths, k and stride decide
the route and the shapes scale with the image): k3s1, k3s2 and k4s2, the
last partial 128-pixel tile, tiles whose rows wrap at W = 1216, 608, 304
and 152. Then a numpy emulation of the consumer (``load_split_a`` in
``csrc/gated_conv_wgmma.cuh``: the word addresses it reads from a raw
stage in the 128-byte swizzle, wgmma's tf32 register-A fragment layout,
the rna split) against ``tf32_split`` of the same im2col, bit for bit.
"""

import numpy as np
import pytest
import torch

from read_tpu_torch.models.unet import UNet
from read_tpu_torch.ops import gated_conv as GC

FULL = (368, 1216)
TINY = (16, 32)   # the recorded frame: FULL / (23, 38)
P = GC.IM2COL_PIXELS   # pixels a load: a tile of both consumer warpgroups


@pytest.fixture(scope="module")
def routed_calls():
    """``{(x shape, k, stride): calls}`` of the K2 calls a full-width B=1
    f32 frame sends to the wgmma loop."""
    calls = {}
    real = GC.gated_conv_kxk

    def shim(x, w, b, scale, offset, res=None, **kw):
        if GC.kxk_route(x, w, (b, scale, offset, res)) == "wgmma":
            _, h, wd, c = x.shape
            key = ((1, h * FULL[0] // TINY[0], wd * FULL[1] // TINY[1], c),
                   w.shape[0], kw.get("stride", 1))
            calls[key] = calls.get(key, 0) + 1
        return real(x, w, b, scale, offset, res, **kw)

    net = UNet().init_weights(torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    pyr = [torch.from_numpy(rng.normal(size=(1, TINY[0] >> i, TINY[1] >> i,
                                             8)).astype(np.float32))
           for i in range(4)]
    GC.gated_conv_kxk = shim
    try:
        with torch.no_grad():
            net(*pyr, operands="f32")
    finally:
        GC.gated_conv_kxk = real
    return calls


def _out_hw(h, w, k, s):
    pad = (k - 1) // 2
    return (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1


def _im2col_rows(x, k, s, rows):
    """numpy im2col of ``x [B, H, W, C]`` for output pixels ``rows`` (flat
    index over ``B x Ho x Wo``): ``[len(rows), k*k*C]``, tap-major, zero
    outside the image."""
    b, h, w, c = x.shape
    pad = (k - 1) // 2
    ho, wo = _out_hw(h, w, k, s)
    n, r = rows // (ho * wo), rows % (ho * wo)
    oy, ox = r // wo, r % wo
    xp = np.pad(x, ((0, 0), (pad, k), (pad, k), (0, 0)))
    taps = [xp[n, oy * s + ky, ox * s + kx] for ky in range(k)
            for kx in range(k)]
    return np.concatenate(taps, axis=-1)


def _loads(x, params, walk, tiles):
    """What each slice's load puts in the stage for ``tiles``: ``[tiles,
    slices, P, 32]``, by the walk's coordinates plus the slice's offsets,
    zero out of bounds."""
    b, h, w, _ = x.shape
    org = walk[tiles].numpy()   # [t, P, 3] (w, h, n)
    out = []
    for c, ow, oh in params["slices"]:
        xs, ys, ns = org[..., 0] + ow, org[..., 1] + oh, org[..., 2]
        ok = (ns < b) & (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        v = x[np.where(ok, ns, 0), np.where(ok, ys, 0), np.where(ok, xs, 0),
              c:c + 32]
        out.append(np.where(ok[..., None], v, 0.0).astype(np.float32))
    return np.stack(out, 1)


def test_routed_calls_of_a_full_width_frame(routed_calls):
    """The 79 routed calls, at k3s1, k3s2 and k4s2, over the four
    levels."""
    assert sum(routed_calls.values()) == 79
    assert {(k, s) for (_, k, s) in routed_calls} == {(3, 1), (3, 2),
                                                      (4, 2)}
    assert {xs[1:3] for (xs, _, _) in routed_calls} >= {
        (368, 1216), (184, 608), (92, 304), (46, 152)}


def test_copy_params_walk_is_im2col_at_every_routed_call(routed_calls):
    """At each routed shape, every tile's P walk rows are its output
    pixels' top-left taps (rows past the last pixel past the last
    image), and the loads of the first, the last (partial) and every
    row-wrapping tile, plus a few others, equal numpy's im2col slice by
    slice."""
    rng = np.random.default_rng(1)
    for (xs, k, s) in sorted(routed_calls):
        b, h, w, c = xs
        pad = (k - 1) // 2
        p = GC.im2col_copy_params(xs, k, s)
        ho, wo = _out_hw(h, w, k, s)
        npix = b * ho * wo
        tiles = -(-npix // P)
        assert p["dims"] == (c, w, h, b) and p["box"] == (32, P)
        assert p["strides"] == (4 * c, 4 * w * c, 4 * h * w * c)
        assert p["lower"] == (-pad, -pad)
        assert p["upper"] == (pad - k + 1, pad - k + 1)
        assert p["element_strides"] == (1, s, s, 1)
        assert len(p["slices"]) == k * k * c // 32
        assert p["starts"].shape == (tiles, 3)
        walk = p["walk"]
        m = np.arange(tiles * P).reshape(tiles, P)
        n, r = m // (ho * wo), m % (ho * wo)
        want = np.stack([(r % wo) * s - pad, (r // wo) * s - pad, n], -1)
        live = m < npix
        assert np.array_equal(walk.numpy()[live], want[live])
        assert (walk.numpy()[~live][:, 2] >= b).all()
        if npix % P:
            assert not live[-1].all()
        # tiles whose P pixels cross the end of an output row
        wraps = np.nonzero((m[:, 0] % wo) + P - 1 >= wo)[0]
        assert len(wraps) > 0
        pick = np.unique(np.concatenate([
            [0, tiles - 1], wraps[:2], wraps[-2:],
            rng.integers(0, tiles, 3)]))
        x = rng.normal(size=xs).astype(np.float32)
        got = _loads(x, p, walk, pick)
        rows = np.minimum(m[pick], npix - 1)
        ref = _im2col_rows(x, k, s, rows.reshape(-1)).reshape(
            len(pick), P, len(p["slices"]), 32).transpose(0, 2, 1, 3)
        lv = live[pick][:, None, :, None]
        assert np.array_equal(np.where(lv, got, 0), np.where(lv, ref, 0))
        assert not np.where(lv, 0, got).any()   # zero fill past the end


def _rna_tf32(v):
    """numpy ``cvt.rna.tf32.f32``: round to 10 mantissa bits, ties away
    from zero (the low 13 bits cleared)."""
    u = v.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _swizzled_stage(tile):
    """The bytes TMA writes for a ``[P, 32]`` f32 load in the 128-byte
    swizzle: 16-byte chunk j of row r at chunk j ^ (r % 8)."""
    chunks = tile.reshape(P, 8, 4)
    stage = np.empty_like(chunks)
    for r in range(P):
        stage[r, np.arange(8) ^ (r % 8)] = chunks[r]
    return stage.reshape(-1).view(np.uint8)


def _consumer_fragments(stage):
    """The f32 consumers' hi and lo A operands of one slice, ``[P, 32]``
    each, as ``load_split_a`` reads them: thread (warp, lane) of the P /
    16 consumer warps, k8 step ks, words at row r0 = 16 warp + lane/4 (+
    8) and byte 4 (lane % 4) of chunks (2 ks) ^ (r0 % 8) and (2 ks + 1) ^
    (r0 % 8); register a_i is row r0 + 8 (i % 2), column 8 ks + lane % 4
    + 4 (i // 2) of the operand (its warpgroup's rows 64 (warp // 4) ..
    + 63)."""
    words = stage.view(np.float32)
    hi = np.full((P, 32), np.nan, np.float32)
    lo = hi.copy()
    for warp in range(P // 16):
        for lane in range(32):
            grp = lane // 4
            r0 = 16 * warp + grp
            src = r0 * 128 + 4 * (lane % 4)
            xg = grp << 4
            for ks in range(4):
                c0, c1 = ((2 * ks) << 4) ^ xg, ((2 * ks + 1) << 4) ^ xg
                addr = [src + c0, src + 8 * 128 + c0, src + c1,
                        src + 8 * 128 + c1]
                for i, a in enumerate(addr):
                    v = words[a // 4:a // 4 + 1]
                    h = _rna_tf32(v)
                    row, col = r0 + 8 * (i % 2), 8 * ks + lane % 4 + 4 * (
                        i // 2)
                    hi[row, col] = h[0]
                    lo[row, col] = _rna_tf32(v - h)[0]
    return hi, lo


@pytest.mark.parametrize("xs,k,s,tile,slc", [
    ((1, 46, 152, 256), 3, 1, 54, 40),    # the last, partial tile
    ((1, 92, 304, 128), 4, 2, 1, 17),     # k4s2, a row-wrapping tile
    ((1, 368, 1216, 32), 3, 2, 4, 4)])    # k3s2, a row-wrapping tile
def test_consumer_fragment_split_matches_tf32_split(xs, k, s, tile, slc):
    """The consumer's register-A words and their rna split, read from the
    swizzled raw stage of one load, are ``tf32_split`` of the im2col
    block they stand for, bit for bit; every element is read once."""
    rng = np.random.default_rng(tile)
    x = (rng.normal(size=xs) * np.exp2(rng.integers(-8, 8, size=xs))
         ).astype(np.float32)
    p = GC.im2col_copy_params(xs, k, s)
    walk = p["walk"]
    block = _loads(x, p, walk, np.array([tile]))[0, slc]   # [P, 32]
    hi, lo = _consumer_fragments(_swizzled_stage(block))
    want_hi, want_lo = GC.tf32_split(torch.from_numpy(block))
    assert np.array_equal(hi.view(np.uint32),
                          want_hi.numpy().view(np.uint32))
    assert np.array_equal(lo.view(np.uint32),
                          want_lo.numpy().view(np.uint32))
