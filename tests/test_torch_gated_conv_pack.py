"""K2's wgmma route on the CPU: the packed bf16 weight, the route, the
module's cache, and the kernel's layout contract.

``pack_kxk_bf16`` is held bit for bit against a plain inverse; the route
against every bf16 K2 call of a full-width ``UNet()`` (recorded with a
shim at a tiny image size: widths decide the route, not the image);
``gated_conv_kxk`` with a packed weight on the CPU against the Pallas
kernel (interpret mode, ``mxu_bf16``); and a plain emulation of what the
kernel computes from the packed blocks (unswizzle, one f32 product per N
tile, f and m read from the accumulator columns ``16q + r`` and ``16q + 8
+ r`` as the epilogue reads its fragments) against the twin, within the
f32 bound ``atol 2e-5, rtol 1e-4`` (same bf16 operands, f32 sums).
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
    """Undo the 128-byte swizzle: row n's chunk j sits at j ^ (n % 8)."""
    nt, s, tn, _ = packed.shape
    b = packed.float().reshape(nt, s, tn, 8, 8)
    src = torch.arange(8)[None, :] ^ (torch.arange(tn)[:, None] % 8)
    return torch.gather(b, 3, src[None, None, :, :, None].expand_as(b)
                        ).reshape(nt, s, tn, 64)


def _unpack(packed, k, cin, cout):
    """Plain inverse of ``pack_kxk_bf16``: ``(w [k, k, cin, 2*cout],
    padding)`` with every padded value (K rows past k*k*cin, columns of
    channels >= cout) in ``padding``."""
    nt, s, tn, _ = packed.shape
    kmat = _unswizzle(packed).permute(1, 3, 0, 2).reshape(s * 64, nt * tn)
    w = torch.full((s * 64, 2 * cout), float("nan"))
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


def _record_kxk_calls(monkeypatch, net, shapes):
    """Run ``net``'s bf16 serving route on the CPU with a shim around
    K2: ``[(x, w)]`` of every call, in order."""
    calls = []
    real = GC.gated_conv_kxk

    def shim(x, w, *args, **kw):
        assert kw["bf16"]
        calls.append((x, w))
        return real(x, w, *args, **kw)

    monkeypatch.setattr(GC, "gated_conv_kxk", shim)
    rng = np.random.default_rng(0)
    pyr = [torch.from_numpy(rng.normal(size=(1, h, w, 8)).astype(
        np.float32)) for h, w in shapes]
    net(*pyr, operands="bf16")
    return calls


def test_route_sends_unet_bf16_calls_to_the_right_loop(monkeypatch):
    """Full-width UNet (base 32, num_res 4): the three SCM convs and feat0
    on the 8-channel descriptors and the Cout=3 head feat5 stay on the
    tile loop; the other 79 K2 calls of a frame take the wgmma loop."""
    net = UNet().init_weights(torch.Generator().manual_seed(0)).eval()
    calls = _record_kxk_calls(monkeypatch, net,
                              [(16, 32), (8, 16), (4, 8), (2, 4)])
    assert len(calls) == 84
    routes = [GC.kxk_route(x, w, True) for x, w in calls]
    old = [(x.shape[-1], w.shape[-1] // 2) for (x, w), r in
           zip(calls, routes) if r == "tile"]
    assert sorted(old) == [(8, 16), (8, 32), (8, 32), (8, 64), (32, 3)]
    for (x, w), r in zip(calls, routes):
        cin, cout = w.shape[2], w.shape[3] // 2
        assert r == ("wgmma" if cin % 32 == 0 and cout % 8 == 0 else "tile")
        assert GC.kxk_route(x, w, False) == "tile"
    assert routes.count("wgmma") == 79


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


def _emulate_wgmma_loop(x, packed, b, scale, offset, res, k, stride, relu):
    """What the wgmma kernel computes from ``packed``: the bf16 input
    patch (tap-major K, zero-padded to the slices), one f32 product per N
    tile against the unswizzled blocks, then f = column 16q + r and m =
    column 16q + 8 + r of each tile for channel tile*tn/2 + 8q + r."""
    bsz, h, wd, cin = x.shape
    nt, s, tn, _ = packed.shape
    cout = scale.shape[0]
    pad = (k - 1) // 2
    xp = torch.nn.functional.pad(GC.round_bf16(x),
                                 (0, 0, pad, k, pad, k))
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    taps = [xp[:, ky:ky + stride * ho:stride, kx:kx + stride * wo:stride]
            for ky in range(k) for kx in range(k)]
    a = torch.cat(taps, -1).reshape(-1, k * k * cin)
    a = torch.nn.functional.pad(a, (0, s * 64 - k * k * cin))
    bmat = _unswizzle(packed).permute(0, 1, 3, 2).reshape(nt, s * 64, tn)
    acc = torch.stack([a @ bmat[t] for t in range(nt)], 1)  # [P, nt, tn]
    acc = acc.reshape(-1, nt, tn // 16, 2, 8)
    f = acc[:, :, :, 0].reshape(-1, nt * tn // 2)[:, :cout]
    m = acc[:, :, :, 1].reshape(-1, nt * tn // 2)[:, :cout]
    fm = torch.cat([f, m], -1).reshape(bsz, ho, wo, 2 * cout)
    return GC.gated_epilogue(fm, b, scale, offset, res, relu)


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
