"""K2's wgmma route on the CPU: the packed weights, the route, the
module's caches, and the kernel's layout contract and arithmetic in both
operand modes.

``pack_kxk_bf16`` and ``pack_kxk_tf32`` are held bit for bit against a
plain inverse (``pack_kxk_tf32`` against ``tf32_split`` of the weight);
the route against every K2 call of a full-width ``UNet()`` in both
operand modes (recorded with a shim at a tiny image size: widths decide
the route, not the image) and against misaligned epilogue views;
``gated_conv_kxk`` with a packed weight on the CPU against the Pallas
kernel (interpret mode, ``mxu_bf16``); and a plain emulation of what the
kernel computes from the packed blocks (unswizzle; one bf16 product, or
the three TF32 products ``hi*hi + hi*lo + lo*hi``, per N tile, summed in
f32; f and m read from the accumulator columns ``16q + r`` and ``16q + 8
+ r`` as the epilogue reads its fragments) against the twin, within the
f32 bound ``atol 2e-5, rtol 1e-4``: bf16 with the same bf16 operands and
f32 sums, f32 up to K2's largest K (9 x 256 = 2304), where one TF32
product alone misses the bound; and at one small shape against the
Pallas kernel in f32 (interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.ops import gated_conv_pack as GP
from read_tpu_torch.models.unet import BasicConv, UNet
from read_tpu_torch.ops import gated_conv as GC

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=0.35, rtol=0.05)


def _unswizzle(packed):
    """Undo the 128-byte swizzle over the last dim (a row of 8 16-byte
    chunks): row n's chunk j sits at j ^ (n % 8)."""
    *lead, tn, row = packed.shape
    b = packed.float().reshape(*lead, tn, 8, row // 8)
    src = torch.arange(8)[None, :] ^ (torch.arange(tn)[:, None] % 8)
    idx = src[:, :, None].expand(tn, 8, row // 8)
    return torch.gather(b, -2, idx.expand_as(b)).reshape(*lead, tn, row)


def _unpack(packed, k, cin, cout):
    """Plain inverse of the block layout ``[nt, s, tn, row]`` of
    ``pack_kxk_bf16`` (and of each part of ``pack_kxk_tf32``): ``(w [k,
    k, cin, 2*cout], padding)`` with every padded value (K rows past
    k*k*cin, columns of channels >= cout) in ``padding``."""
    nt, s, tn, row = packed.shape
    kmat = _unswizzle(packed).permute(1, 3, 0, 2).reshape(s * row, nt * tn)
    w = torch.full((s * row, 2 * cout), float("nan"))
    pad = [kmat[k * k * cin:].flatten()]
    for col in range(nt * tn):
        t, n = divmod(col, tn)
        g = n // 8
        ch = t * tn // 2 + 8 * (g // 2) + n % 8
        if ch < cout:
            w[:, ch + cout * (g % 2)] = kmat[:, col]
        else:
            pad.append(kmat[:, col])
    return (w[:k * k * cin].reshape(k, k, cin, 2 * cout),
            torch.cat(pad))


@pytest.mark.parametrize("shape", [(3, 3, 32, 64), (4, 4, 64, 128),
                                   (3, 3, 128, 256)])
def test_pack_kxk_bf16_inverts_to_rounded_weight(shape):
    k, _, cin, c2 = shape
    rng = np.random.default_rng(c2)
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    packed = GC.pack_kxk_bf16(w)
    tn = GC.wgmma_tile_n(c2 // 2)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (-(-(c2 // 2) // (tn // 2)),
                                   -(-k * k * cin // 64), tn, 64)
    got, pad = _unpack(packed, k, cin, c2 // 2)
    assert torch.equal(got, GC.round_bf16(w))
    assert pad.numel() == 0 or not bool(pad.any())


def _record_kxk_calls(monkeypatch, net, shapes, operands="bf16"):
    """Run ``net``'s serving route on the CPU with a shim around K2:
    ``[(x, w, epilogue)]`` of every call, in order (``epilogue``: bias,
    scale, offset and residual)."""
    calls = []
    real = GC.gated_conv_kxk

    def shim(x, w, b, scale, offset, res=None, **kw):
        assert kw["bf16"] == (operands == "bf16")
        calls.append((x, w, (b, scale, offset, res)))
        return real(x, w, b, scale, offset, res, **kw)

    monkeypatch.setattr(GC, "gated_conv_kxk", shim)
    rng = np.random.default_rng(0)
    pyr = [torch.from_numpy(rng.normal(size=(1, h, w, 8)).astype(
        np.float32)) for h, w in shapes]
    net(*pyr, operands=operands)
    return calls


def _check_unet_routes(calls):
    """The three SCM convs and feat0 on the 8-channel descriptors and the
    Cout=3 head feat5 stay on the tile loop; the other 79 K2 calls of a
    full-width frame take the wgmma loop."""
    assert len(calls) == 84
    routes = [GC.kxk_route(x, w, ep) for x, w, ep in calls]
    old = [(x.shape[-1], w.shape[-1] // 2) for (x, w, _), r in
           zip(calls, routes) if r == "tile"]
    assert sorted(old) == [(8, 16), (8, 32), (8, 32), (8, 64), (32, 3)]
    for (x, w, _), r in zip(calls, routes):
        cin, cout = w.shape[2], w.shape[3] // 2
        assert r == ("wgmma" if cin % 32 == 0 and cout % 8 == 0 else "tile")
    assert routes.count("wgmma") == 79


def test_route_sends_unet_bf16_calls_to_the_right_loop(monkeypatch):
    """Full-width UNet (base 32, num_res 4), bf16 operands."""
    net = UNet().init_weights(torch.Generator().manual_seed(0)).eval()
    _check_unet_routes(_record_kxk_calls(
        monkeypatch, net, [(16, 32), (8, 16), (4, 8), (2, 4)]))


def test_route_sends_unet_f32_calls_to_the_right_loop(monkeypatch):
    """The same frame with f32 operands: the same 79 calls take the wgmma
    loop (its TF32 x3 mode)."""
    net = UNet().init_weights(torch.Generator().manual_seed(0)).eval()
    _check_unet_routes(_record_kxk_calls(
        monkeypatch, net, [(16, 32), (8, 16), (4, 8), (2, 4)], "f32"))


def test_route_keeps_misaligned_views_on_the_tile_loop():
    """The loop's epilogue reads bias, scale, offset and the residual as
    channel pairs, and its producer reads x as 16-byte vectors: a view of
    any of them at a 4-byte offset keeps the tile loop, whatever the
    operand type (the route does not depend on it)."""
    x = torch.zeros(2, 6, 7, 64)
    w = torch.zeros(3, 3, 64, 64)
    flat = torch.zeros(2 * 6 * 7 * 32 + 1)
    res = flat[:-1].view(2, 6, 7, 32)
    off = flat[1:].view(2, 6, 7, 32)                          # 4-byte off
    assert off.is_contiguous() and off.data_ptr() % 8 == 4
    vec = torch.zeros(65)
    b, scale, offset = vec[:64], vec[:32], vec[32:64]
    good = (b, scale, offset, res)
    assert GC.kxk_route(x, w, good) == "wgmma"
    assert GC.kxk_route(x, w, good[:3] + (None,)) == "wgmma"
    assert GC.kxk_route(x, w, good[:3] + (off,)) == "tile"
    for i in range(3):
        bad = list(good)
        bad[i] = vec[1:1 + good[i].numel()]
        assert GC.kxk_route(x, w, bad) == "tile"
    xflat = torch.zeros(2 * 6 * 7 * 64 + 4)
    xoff = xflat[4:].view(2, 6, 7, 64)                        # 16-byte off
    assert GC.kxk_route(xoff, w, good) == "wgmma"
    assert GC.kxk_route(xflat[2:-2].view(2, 6, 7, 64), w, good) == "tile"
    assert GC.kxk_route(x[..., :32].contiguous(), w[:, :, :32], good) \
        == "wgmma"
    assert GC.kxk_route(torch.zeros(2, 6, 7, 8), w[:, :, :8]) == "tile"
    assert GC.kxk_route(x, w[..., :6]) == "tile"              # Cout = 3


def test_packed_weight_cache_is_reused_and_rebuilt_after_a_write():
    conv = BasicConv(32, 32, 3)
    with torch.no_grad():
        conv.conv_fm.kernel.normal_()
    first = conv.packed_kxk_bf16()
    assert conv.packed_kxk_bf16() is first
    assert torch.equal(first, GC.pack_kxk_bf16(conv.conv_fm.kernel))
    with torch.no_grad():
        conv.conv_fm.kernel.mul_(2.0)
    second = conv.packed_kxk_bf16()
    assert second is not first
    assert torch.equal(second, GC.pack_kxk_bf16(conv.conv_fm.kernel))
    assert conv.packed_kxk_bf16() is second


def _chw(x):
    _, h, w, c = x.shape
    return jnp.asarray(x[0].transpose(2, 0, 1).reshape(c, h * w))


@pytest.mark.parametrize("relu,with_res", [(True, False), (False, True)])
def test_kxk_with_packed_weight_matches_pallas_mxu_bf16(relu, with_res):
    rng = np.random.default_rng(21 + with_res)
    cin, cout, h, w = 32, 32, 6, 9
    x = rng.normal(size=(1, h, w, cin)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, cin, 2 * cout)) * 0.2).astype(np.float32)
    b = rng.normal(size=2 * cout).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    offset = rng.normal(size=cout).astype(np.float32)
    res = (rng.normal(size=(1, h, w, cout)).astype(np.float32)
           if with_res else None)
    want = GP.gated_conv3x3_chw(
        _chw(x), jnp.asarray(wk), jnp.asarray(b), jnp.asarray(scale),
        jnp.asarray(offset), None if res is None else _chw(res), w_img=w,
        relu=relu, rows=2, interpret=True, impl="dot3", mxu_bf16=True)
    want = np.asarray(want).reshape(cout, h, w).transpose(1, 2, 0)[None]
    t = [torch.from_numpy(a) for a in (x, wk, b, scale, offset)]
    before = dict(GC.launches)
    got = GC.gated_conv_kxk(*t, None if res is None else
                            torch.from_numpy(res), relu=relu, bf16=True,
                            packed=GC.pack_kxk_bf16(t[1]))
    assert GC.launches == before   # the twin ran: nothing launched
    np.testing.assert_allclose(got.numpy(), want, **BF16)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def _emulate_wgmma_loop(x, packed, b, scale, offset, res, k, stride, relu,
                        products=3):
    """What the wgmma kernel computes from ``packed``: the input patch
    (tap-major K, zero-padded to the slices) as A, bf16-rounded for a
    bf16 pack or split into TF32 hi and lo for a TF32 pack; per N tile
    one f32 product against the unswizzled bf16 blocks, or the TF32
    products ``hi*hi + hi*lo + lo*hi`` (the first ``products`` of them);
    then f = column 16q + r and m = column 16q + 8 + r of each tile for
    channel tile*tn/2 + 8q + r."""
    bsz, h, wd, cin = x.shape
    bf16 = packed.dtype == torch.bfloat16
    nt, s = packed.shape[:2]
    row = 64 if bf16 else 32
    cout = scale.shape[0]
    pad = (k - 1) // 2
    xp = torch.nn.functional.pad(x, (0, 0, pad, k, pad, k))
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    taps = [xp[:, ky:ky + stride * ho:stride, kx:kx + stride * wo:stride]
            for ky in range(k) for kx in range(k)]
    a = torch.cat(taps, -1).reshape(-1, k * k * cin)
    a = torch.nn.functional.pad(a, (0, s * row - k * k * cin))

    def bmat(blocks):   # [nt, s, tn, row] -> [nt, s*row, tn]
        u = _unswizzle(blocks)
        return u.permute(0, 1, 3, 2).reshape(nt, s * row, u.shape[2])

    if bf16:
        bb = bmat(packed)
        acc = torch.stack([GC.round_bf16(a) @ bb[t] for t in range(nt)], 1)
    else:
        a_hi, a_lo = GC.tf32_split(a)
        b_hi, b_lo = bmat(packed[:, :, 0]), bmat(packed[:, :, 1])
        acc = torch.stack([sum([a_hi @ b_hi[t], a_hi @ b_lo[t],
                                a_lo @ b_hi[t]][:products])
                           for t in range(nt)], 1)         # [P, nt, tn]
    tn = acc.shape[-1]
    acc = acc.reshape(-1, nt, tn // 16, 2, 8)
    f = acc[:, :, :, 0].reshape(-1, nt * tn // 2)[:, :cout]
    m = acc[:, :, :, 1].reshape(-1, nt * tn // 2)[:, :cout]
    fm = torch.cat([f, m], -1).reshape(bsz, ho, wo, 2 * cout)
    return GC.gated_epilogue(fm, b, scale, offset, res, relu)


def _kxk_case(rng, cin, cout, k, batch, hw):
    x = torch.from_numpy(rng.normal(size=(batch, *hw, cin)).astype(
        np.float32))
    w = torch.from_numpy((rng.normal(size=(k, k, cin, 2 * cout))
                          / (k * k * cin) ** 0.5).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=2 * cout) * 0.1).astype(
        np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
    offset = torch.from_numpy((rng.normal(size=cout) * 0.1).astype(
        np.float32))
    return x, w, b, scale, offset


@pytest.mark.parametrize("shape", [(3, 3, 32, 64), (4, 4, 128, 128),
                                   (3, 3, 256, 512)])
def test_pack_kxk_tf32_inverts_to_tf32_split(shape):
    k, _, cin, c2 = shape
    rng = np.random.default_rng(c2 + cin)
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    packed = GC.pack_kxk_tf32(w)
    tn = GC.wgmma_tile_n(c2 // 2)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert tuple(packed.shape) == (-(-(c2 // 2) // (tn // 2)),
                                   k * k * cin // 32, 2, tn, 32)
    want_hi, want_lo = GC.tf32_split(w)
    for part, want in ((0, want_hi), (1, want_lo)):
        got, pad = _unpack(packed[:, :, part], k, cin, c2 // 2)
        assert torch.equal(got, want)
        assert pad.numel() == 0 or not bool(pad.any())


@pytest.mark.parametrize("cin,cout,k,stride,hw", [
    (32, 32, 3, 1, (7, 10)), (256, 256, 3, 1, (3, 5)),
    (128, 64, 3, 2, (7, 9)), (128, 128, 4, 2, (6, 8))])
def test_tf32_loop_arithmetic_matches_twin(cin, cout, k, stride, hw):
    """Three TF32 products hold the f32 bound against the exact f32 twin
    at K2's shapes, K = 9 x 256 = 2304 included, relu on without a
    residual and off with one; at K = 2304 one product alone does not."""
    rng = np.random.default_rng(7 * cin + cout + k)
    x, w, b, scale, offset = _kxk_case(rng, cin, cout, k, 2, hw)
    packed = GC.pack_kxk_tf32(w)
    want = GC.gated_conv_kxk_plain(x, w, b, scale, offset, stride=stride)
    res = torch.from_numpy(rng.normal(size=want.shape).astype(np.float32))
    for r, relu in ((None, True), (res, False)):
        want = GC.gated_conv_kxk_plain(x, w, b, scale, offset, r,
                                       stride=stride, relu=relu)
        got = _emulate_wgmma_loop(x, packed, b, scale, offset, r, k,
                                  stride, relu)
        torch.testing.assert_close(got, want, **F32)
    if k * k * cin == 2304:
        one = _emulate_wgmma_loop(x, packed, b, scale, offset, res, k,
                                  stride, False, products=1)
        assert not torch.allclose(one, want, **F32)


def test_tf32_loop_arithmetic_matches_pallas_f32():
    """The emulated TF32 x3 loop against the JAX kernel in f32 (interpret
    mode, ``mxu_bf16=False``), with and without a residual; the wrapper
    on the CPU runs the twin with a TF32 pack given and launches
    nothing."""
    rng = np.random.default_rng(23)
    cin, cout, h, w = 32, 32, 6, 9
    x, wk, b, scale, offset = _kxk_case(rng, cin, cout, 3, 1, (h, w))
    res = torch.from_numpy(rng.normal(size=(1, h, w, cout)).astype(
        np.float32))
    packed = GC.pack_kxk_tf32(wk)
    for r, relu in ((None, True), (res, False)):
        want = GP.gated_conv3x3_chw(
            _chw(x.numpy()), *(jnp.asarray(t.numpy())
                               for t in (wk, b, scale, offset)),
            None if r is None else _chw(r.numpy()), w_img=w, relu=relu,
            rows=2, interpret=True, impl="dot3", mxu_bf16=False)
        want = np.asarray(want).reshape(cout, h, w).transpose(1, 2, 0)[None]
        got = _emulate_wgmma_loop(x, packed, b, scale, offset, r, 3, 1,
                                  relu)
        np.testing.assert_allclose(got.numpy(), want, **F32)
        before = dict(GC.launches)
        twin = GC.gated_conv_kxk(x, wk, b, scale, offset, r, relu=relu,
                                 packed=packed)
        assert GC.launches == before
        np.testing.assert_allclose(twin.numpy(), want, **F32)


def test_tf32_pack_cache_is_reused_and_rebuilt_after_a_write():
    conv = BasicConv(32, 64, 3)
    with torch.no_grad():
        conv.conv_fm.kernel.normal_()
    first = conv.packed_kxk_tf32()
    assert conv.packed_kxk_tf32() is first
    assert torch.equal(first, GC.pack_kxk_tf32(conv.conv_fm.kernel))
    assert conv.packed_kxk_bf16() is not first
    with torch.no_grad():
        conv.conv_fm.kernel.mul_(2.0)
    second = conv.packed_kxk_tf32()
    assert second is not first
    assert torch.equal(second, GC.pack_kxk_tf32(conv.conv_fm.kernel))


@pytest.mark.parametrize("cin,cout,k,stride,hw", [
    (32, 32, 3, 1, (7, 10)), (64, 64, 3, 2, (8, 11)),
    (64, 128, 4, 2, (6, 8)), (128, 256, 3, 1, (3, 5)),
    (32, 40, 3, 1, (5, 6))])
def test_wgmma_layout_contract_matches_twin(cin, cout, k, stride, hw):
    rng = np.random.default_rng(cin + cout + k)
    x = torch.from_numpy(rng.normal(size=(2, *hw, cin)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, k, cin, 2 * cout))
                          / (k * k * cin) ** 0.5).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=2 * cout).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
    offset = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
    want = GC.gated_conv_kxk_plain(x, w, b, scale, offset, stride=stride,
                                   relu=True, bf16=True)
    res = torch.from_numpy(rng.normal(size=want.shape).astype(np.float32))
    for r, relu in ((None, True), (res, False)):
        want = GC.gated_conv_kxk_plain(x, w, b, scale, offset, r,
                                       stride=stride, relu=relu, bf16=True)
        got = _emulate_wgmma_loop(x, GC.pack_kxk_bf16(w), b, scale, offset,
                                  r, k, stride, relu)
        torch.testing.assert_close(got, want, **F32)
