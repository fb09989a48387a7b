"""K3 and K4's 1x1 wgmma loop on the CPU: the packed weights, the TF32
split, the route, the module's caches, and the loop's arithmetic.

``pack_1x1_bf16`` and ``pack_1x1_tf32`` are held bit for bit against a
plain inverse at the SCM widths (K3's weights and K4's concat weights);
:func:`tf32_split` against ``cvt.rna.tf32.f32``'s definition (low 13 bits
zero, round to nearest with ties away from zero, ``hi + lo`` within
2^-22 of ``x``); the route against every K3/K4 call of a full-width
``UNet()`` (recorded with shims at a tiny image: widths decide the
route). A plain emulation of what the kernel computes from the packed
blocks (unswizzle; three TF32 products ``hi*hi + hi*lo + lo*hi`` or one
bf16 product per N tile, summed in f32; f and m read from the
accumulator columns ``16q + r`` and ``16q + 8 + r``) is held within the
f32 bound ``atol 2e-5, rtol 1e-4`` against the twins and against the JAX
kernels ``gated_conv1x1_chw`` / ``gated_conv1x1_cat_chw`` (interpret
mode; for bf16 operands the JAX side gets operands already rounded to
bf16, as ``tests/test_torch_gated_conv.py`` and
``tests/test_torch_cat_conv.py`` run them: the same exact products and
f32 sums as ``mxu_bf16``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.ops import gated_conv_pack as GP
from read_tpu_torch.models.unet import BasicConv, UNet
from read_tpu_torch.ops import gated_conv as GC

F32 = dict(atol=2e-5, rtol=1e-4)

# (input widths, Cout) of a full-width frame's 1x1 calls: K3's six, then
# K4's three SCM BasicConv_4 sites
SCM_1X1 = (((16,), 32), ((32,), 56), ((32,), 64), ((64,), 120),
           ((64,), 128), ((128,), 248), ((8, 56), 64), ((8, 120), 128),
           ((8, 248), 256))


def _ids(cases):
    return ["+".join(map(str, cins)) + f"->{cout}" for cins, cout in cases]


def _unswizzle(packed):
    """Undo the 128-byte swizzle over the last dim (a row of 8 16-byte
    chunks): row n's chunk j sits at j ^ (n % 8)."""
    *lead, tn, row = packed.shape
    b = packed.float().reshape(*lead, tn, 8, row // 8)
    src = torch.arange(8)[None, :] ^ (torch.arange(tn)[:, None] % 8)
    idx = src[:, :, None].expand(tn, 8, row // 8)
    return torch.gather(b, -2, idx.expand_as(b)).reshape(*lead, tn, row)


def _unpack(blocks, k, cout):
    """Plain inverse of the block layout ``[nt, s, tn, row]``: ``(w [k,
    2*cout], padding)``, every padded value (K rows past k, columns of
    channels >= cout) in ``padding``."""
    nt, s, tn, row = blocks.shape
    kmat = _unswizzle(blocks).permute(1, 3, 0, 2).reshape(s * row, nt * tn)
    w = torch.full((s * row, 2 * cout), float("nan"))
    pad = [kmat[k:].flatten()]
    for col in range(nt * tn):
        t, n = divmod(col, tn)
        g = n // 8
        ch = t * tn // 2 + 8 * (g // 2) + n % 8
        if ch < cout:
            w[:, ch + cout * (g % 2)] = kmat[:, col]
        else:
            pad.append(kmat[:, col])
    return w[:k], torch.cat(pad)


def _rna_tf32_ref(x):
    """``cvt.rna.tf32.f32`` by its definition, in float64: the nearest
    value with 10 mantissa bits, ties away from zero."""
    x = x.double()
    m, e = torch.frexp(x)                       # x = m * 2^e, |m| in [.5, 1)
    q = torch.sign(m) * torch.floor(m.abs() * 2.0 ** 11 + 0.5)
    return torch.ldexp(q / 2.0 ** 11, e).float()


def test_tf32_split_rounds_as_cvt_rna():
    rng = np.random.default_rng(0)
    x = rng.normal(size=4096).astype(np.float32) \
        * np.exp2(rng.integers(-20, 20, size=4096)).astype(np.float32)
    bits = x.view(np.int32)
    # every 8th value an exact tie: the low 13 bits are 0x1000
    bits[::8] = (bits[::8] & ~0x1FFF) | 0x1000
    x = torch.from_numpy(bits.view(np.float32))
    hi, lo = GC.tf32_split(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    assert torch.equal(hi, _rna_tf32_ref(x))
    assert torch.equal(lo, _rna_tf32_ref(x - hi))
    ties = x[::8]
    # ties go away from zero: |hi| is |x| rounded up
    assert bool((hi[::8].abs() > ties.abs()).all())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert float((lo != 0).float().mean()) > 0.9


@pytest.mark.parametrize("cins,cout", SCM_1X1, ids=_ids(SCM_1X1))
@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
def test_pack_1x1_inverts(cins, cout, bf16):
    k = sum(cins)
    rng = np.random.default_rng(k + cout)
    w = torch.from_numpy(rng.normal(size=(1, 1, k, 2 * cout)).astype(
        np.float32))
    tn = GC.CONV1X1_TILE_N
    nt = -(-cout // (tn // 2))
    if bf16:
        packed = GC.pack_1x1_bf16(w)
        assert packed.dtype == torch.bfloat16
        assert tuple(packed.shape) == (nt, -(-k // 64), tn, 64)
        got, pad = _unpack(packed, k, cout)
        assert torch.equal(got, GC.round_bf16(w[0, 0]))
        assert pad.numel() == 0 or not bool(pad.any())
        return
    packed = GC.pack_1x1_tf32(w)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert tuple(packed.shape) == (nt, -(-k // 32), 2, tn, 32)
    hi, pad_hi = _unpack(packed[:, :, 0], k, cout)
    lo, pad_lo = _unpack(packed[:, :, 1], k, cout)
    want_hi = _rna_tf32_ref(w[0, 0])
    assert torch.equal(hi, want_hi)
    assert torch.equal(lo, _rna_tf32_ref(w[0, 0] - want_hi))
    for pad in (pad_hi, pad_lo):
        assert pad.numel() == 0 or not bool(pad.any())


def _emulate_1x1_loop(xs, packed, b, scale, offset, res, relu, bf16):
    """What the 1x1 wgmma kernel computes from ``packed``: the concat of
    ``xs`` as A (bf16-rounded, or split into TF32 hi and lo), K padded
    to the slices, per N tile one bf16 product or the three TF32
    products against the unswizzled blocks, then f = column 16q + r and
    m = column 16q + 8 + r of each tile for channel tile*tn/2 + 8q + r."""
    lead = xs[0].shape[:-1]
    a = torch.cat(xs, -1).reshape(-1, sum(x.shape[-1] for x in xs))
    cout = scale.shape[0]
    nt, s = packed.shape[:2]
    row = 64 if bf16 else 32
    a = torch.nn.functional.pad(a, (0, s * row - a.shape[1]))

    def bmat(blocks):   # [nt, s, tn, row] -> [nt, s*row, tn]
        u = _unswizzle(blocks)
        return u.permute(0, 1, 3, 2).reshape(nt, s * row, u.shape[2])

    if bf16:
        bb = bmat(packed)
        acc = torch.stack([GC.round_bf16(a) @ bb[t] for t in range(nt)], 1)
    else:
        a_hi, a_lo = GC.tf32_split(a)
        b_hi, b_lo = bmat(packed[:, :, 0]), bmat(packed[:, :, 1])
        acc = torch.stack([a_hi @ b_hi[t] + a_hi @ b_lo[t] + a_lo @ b_hi[t]
                           for t in range(nt)], 1)
    tn = acc.shape[-1]
    acc = acc.reshape(-1, nt, tn // 16, 2, 8)
    f = acc[:, :, :, 0].reshape(-1, nt * tn // 2)[:, :cout]
    m = acc[:, :, :, 1].reshape(-1, nt * tn // 2)[:, :cout]
    fm = torch.cat([f, m], -1).reshape(*lead, 2 * cout)
    return GC.gated_epilogue(fm, b, scale, offset, res, relu)


def _round(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                      .astype(jnp.float32))


@pytest.mark.parametrize("cins,cout", SCM_1X1, ids=_ids(SCM_1X1))
@pytest.mark.parametrize("bf16", [False, True], ids=["tf32", "bf16"])
def test_loop_arithmetic_matches_twin_and_pallas(cins, cout, bf16):
    """The emulated loop at the SCM widths over 150 pixels (a ragged last
    64-pixel tile), relu on without a residual and off with one."""
    k, n = sum(cins), 150
    rng = np.random.default_rng(3 * k + cout + bf16)
    xs = [rng.normal(size=(n, c)).astype(np.float32) for c in cins]
    wk = (rng.normal(size=(1, 1, k, 2 * cout)) / k ** 0.5).astype(
        np.float32)
    b = (rng.normal(size=2 * cout) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    offset = (rng.normal(size=cout) * 0.1).astype(np.float32)
    r = rng.normal(size=(n, cout)).astype(np.float32)
    txs = [torch.from_numpy(x) for x in xs]
    tw, tb, ts, to = map(torch.from_numpy, (wk, b, scale, offset))
    packed = GC.pack_1x1_bf16(tw) if bf16 else GC.pack_1x1_tf32(tw)
    jx, jw = ([_round(x) for x in xs], _round(wk)) if bf16 else (xs, wk)
    jargs = (jnp.asarray(jw), jnp.asarray(b), jnp.asarray(scale),
             jnp.asarray(offset))
    for relu, res in ((True, None), (False, r)):
        tres = None if res is None else torch.from_numpy(res)
        got = _emulate_1x1_loop(txs, packed, tb, ts, to, tres, relu, bf16)
        if len(cins) == 1:
            twin = GC.gated_conv_1x1_plain(txs[0], tw, tb, ts, to, tres,
                                           relu=relu, bf16=bf16)
            want = GP.gated_conv1x1_chw(
                jnp.asarray(jx[0].T), *jargs,
                None if res is None else jnp.asarray(res.T), relu=relu,
                lanes=128, interpret=True)
        else:
            twin = GC.gated_conv_1x1_cat_plain(txs, tw, tb, ts, to, tres,
                                               relu=relu, bf16=bf16)
            want = GP.gated_conv1x1_cat_chw(
                tuple(jnp.asarray(x.T) for x in jx), *jargs,
                None if res is None else jnp.asarray(res.T), relu=relu,
                lanes=128, interpret=True)
        torch.testing.assert_close(got, twin, **F32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want).T, **F32)
    if not bf16:   # three products, not one: one TF32 product misses
        a = torch.cat(txs, -1)
        one = GC.tf32_split(a)[0] @ GC.tf32_split(tw[0, 0])[0]
        assert not torch.allclose(one, a @ tw[0, 0], **F32)


def _record_1x1_calls(monkeypatch, net, operands):
    """Run ``net``'s serving route on the CPU at a tiny image with shims
    around K3 and K4: ``[(name, xs, cout, gated, epilogue)]`` of every
    call (``epilogue``: bias, scale, offset and residual)."""
    calls = []
    real = (GC.gated_conv_1x1, GC.gated_conv_1x1_cat)

    def epilogue(args, kw):
        return tuple(args) + ((kw["res"],) if "res" in kw else ())

    def k3(x, w, *args, **kw):
        calls.append(("k3", [x], w.shape[-1] // 2, True,
                      epilogue(args, kw)))
        return real[0](x, w, *args, **kw)

    def k4(xs, w, *args, **kw):
        gated = kw.get("gated", True)
        calls.append(("k4", list(xs), w.shape[-1] // (2 if gated else 1),
                      gated, epilogue(args, kw)))
        return real[1](xs, w, *args, **kw)

    monkeypatch.setattr(GC, "gated_conv_1x1", k3)
    monkeypatch.setattr(GC, "gated_conv_1x1_cat", k4)
    rng = np.random.default_rng(0)
    pyr = [torch.from_numpy(rng.normal(size=(1, h, w, 8)).astype(
        np.float32)) for h, w in [(16, 32), (8, 16), (4, 8), (2, 4)]]
    net(*pyr, operands=operands)
    return calls


@pytest.mark.parametrize("operands", ["f32", "bf16"])
def test_route_sends_the_frame_1x1_calls_to_the_loop(monkeypatch,
                                                     operands):
    """Full-width UNet (base 32, num_res 4): all 9 K3/K4 calls of a frame
    (6 SCM 1x1 convs, 3 SCM BasicConv_4) take the 1x1 wgmma loop."""
    net = UNet().init_weights(torch.Generator().manual_seed(0)).eval()
    calls = _record_1x1_calls(monkeypatch, net, operands)
    got = sorted((tuple(x.shape[-1] for x in xs), cout)
                 for _, xs, cout, _, _ in calls)
    assert got == sorted(SCM_1X1)
    assert all(len(ep) >= 3 for *_, ep in calls)
    routes = [GC.conv1x1_route(xs, cout, gated, ep)
              for _, xs, cout, gated, ep in calls]
    assert routes.count("wgmma") == 9 == len(calls)


def test_route_keeps_the_rest_on_the_tile_loop():
    x = torch.zeros(2, 3, 5, 64)
    assert GC.conv1x1_route([x], 64) == "wgmma"
    assert GC.conv1x1_route([x[..., :8], x[..., 8:]], 32) == "wgmma"
    assert GC.conv1x1_route([x], 64, gated=False) == "tile"
    assert GC.conv1x1_route([x[..., :12]], 64) == "tile"     # C % 8
    assert GC.conv1x1_route([x[..., :8], x[..., :5]], 64) == "tile"
    assert GC.conv1x1_route([x], 60) == "tile"               # Cout % 8
    flat = torch.zeros(30 * 8 + 1)
    view = flat[1:].view(30, 8)                               # 4-byte off
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert GC.conv1x1_route([view], 8) == "tile"


def test_route_keeps_misaligned_epilogue_views_on_the_tile_loop():
    """The loop's epilogue reads bias, scale, offset and the residual as
    channel pairs: a view of any of them at a 4-byte offset keeps the
    tile loop."""
    x = torch.zeros(2, 3, 5, 64)
    flat = torch.zeros(2 * 3 * 5 * 32 + 1)
    res = flat[:-1].view(2, 3, 5, 32)
    off = flat[1:].view(2, 3, 5, 32)                          # 4-byte off
    assert off.is_contiguous() and off.data_ptr() % 8 == 4
    vec = torch.zeros(65)
    b, scale, offset = vec[:64], vec[:32], vec[32:64]
    good = (b, scale, offset, res)
    assert GC.conv1x1_route([x], 32, epilogue=good) == "wgmma"
    assert GC.conv1x1_route([x], 32, epilogue=good[:3] + (None,)) == "wgmma"
    assert GC.conv1x1_route([x], 32, epilogue=good[:3] + (off,)) == "tile"
    for i in range(3):
        bad = list(good)
        bad[i] = vec[1:1 + good[i].numel()]
        assert GC.conv1x1_route([x], 32, epilogue=bad) == "tile"
        assert GC.conv1x1_route([x[..., :8], x[..., 8:]], 32, True,
                                bad) == "tile"


def test_unet_prepare_fills_the_caches_the_wrappers_read():
    """``UNet.prepare`` (a renderer calls it at load) folds every BN and
    packs every 1x1 BasicConv's loop weight and every k x k conv's K2
    weight for the operand type (TF32 parts for f32); the getters then
    return the cached packs without packing again."""
    net = UNet(base_channel=8, num_res=1).init_weights(
        torch.Generator().manual_seed(0)).eval()
    convs = [m for m in net.modules() if isinstance(m, BasicConv)]
    net.prepare("f32")
    for m in convs:
        keys = set(m._packed)
        assert keys == ({GC.pack_1x1_tf32} if m.k == 1
                        else {GC.pack_kxk_tf32})
        assert m._folded is not None
        assert m.folded_bn() is m._folded[1]
    net.prepare("bf16")
    cached = {id(m): {f: hit[1] for f, hit in m._packed.items()}
              for m in convs}
    for m in convs:
        if m.k == 1:
            assert m.packed_1x1(True) is cached[id(m)][GC.pack_1x1_bf16]
            assert m.packed_1x1(False) is cached[id(m)][GC.pack_1x1_tf32]
            assert torch.equal(m.packed_1x1(True),
                               GC.pack_1x1_bf16(m.conv_fm.kernel))
        else:
            assert m.packed_kxk_bf16() is cached[id(m)][GC.pack_kxk_bf16]
            assert m.packed_kxk_tf32() is cached[id(m)][GC.pack_kxk_tf32]
            assert torch.equal(m.packed_kxk_tf32(),
                               GC.pack_kxk_tf32(m.conv_fm.kernel))
    with pytest.raises(ValueError):
        net.prepare("f16")


def test_wrappers_call_the_packed_getter_only_on_the_wgmma_route():
    """``packed`` may be a function returning the packed weight: the CPU
    twins never call it (nor does a tile-loop call); ``_resolve_packed``
    calls it, packs when it is None and passes a tensor through."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 4, 6, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(1, 1, 64, 64)).astype(np.float32))
    w3 = torch.from_numpy(rng.normal(size=(3, 3, 64, 64)).astype(
        np.float32))
    b, scale, offset = (torch.from_numpy(rng.normal(size=s).astype(
        np.float32)) for s in (64, 32, 32))

    def never():
        raise AssertionError("the getter ran on the CPU")

    for bf16 in (False, True):
        got = GC.gated_conv_1x1(x, w, b, scale, offset, bf16=bf16,
                                packed=never)
        assert torch.equal(got, GC.gated_conv_1x1_plain(
            x, w, b, scale, offset, bf16=bf16))
        got = GC.gated_conv_1x1_cat([x[..., :8].contiguous(),
                                     x[..., 8:].contiguous()], w, b, scale,
                                    offset, bf16=bf16, packed=never)
        torch.testing.assert_close(got, GC.gated_conv_1x1_plain(
            x, w, b, scale, offset, bf16=bf16), **F32)
        got = GC.gated_conv_kxk(x, w3, b, scale, offset, bf16=bf16,
                                packed=never)
        assert torch.equal(got, GC.gated_conv_kxk_plain(
            x, w3, b, scale, offset, bf16=bf16))
    packed = GC.pack_1x1_tf32(w)
    assert GC._resolve_packed(packed, never, w) is packed
    assert GC._resolve_packed(lambda: packed, never, w) is packed
    assert torch.equal(GC._resolve_packed(None, GC.pack_1x1_tf32, w),
                       packed)


def test_1x1_pack_caches_are_reused_and_rebuilt_after_a_write():
    conv = BasicConv(64, 128, 1)
    with torch.no_grad():
        conv.conv_fm.kernel.normal_()
    first = {bf16: conv.packed_1x1(bf16) for bf16 in (False, True)}
    for bf16, packed in first.items():
        assert conv.packed_1x1(bf16) is packed
    assert torch.equal(first[True], GC.pack_1x1_bf16(conv.conv_fm.kernel))
    assert torch.equal(first[False], GC.pack_1x1_tf32(conv.conv_fm.kernel))
    with torch.no_grad():
        conv.conv_fm.kernel.mul_(2.0)
    for bf16, pack in ((True, GC.pack_1x1_bf16),
                       (False, GC.pack_1x1_tf32)):
        second = conv.packed_1x1(bf16)
        assert second is not first[bf16]
        assert torch.equal(second, pack(conv.conv_fm.kernel))
        assert conv.packed_1x1(bf16) is second


def test_1x1_wrappers_take_a_packed_weight_on_the_cpu():
    """On the CPU the twin runs and ``packed`` is ignored: the same
    output, nothing launched."""
    rng = np.random.default_rng(4)
    xs = [torch.from_numpy(rng.normal(size=(2, 3, 5, c)).astype(
        np.float32)) for c in (8, 56)]
    w = torch.from_numpy(rng.normal(size=(1, 1, 64, 128)).astype(
        np.float32))
    b, scale, offset = (torch.from_numpy(rng.normal(size=s).astype(
        np.float32)) for s in (128, 64, 64))
    before = dict(GC.launches)
    for bf16 in (False, True):
        packed = GC.pack_1x1_bf16(w) if bf16 else GC.pack_1x1_tf32(w)
        got = GC.gated_conv_1x1_cat(xs, w, b, scale, offset, bf16=bf16,
                                    packed=packed)
        want = GC.gated_conv_1x1_cat_plain(xs, w, b, scale, offset,
                                           bf16=bf16)
        assert torch.equal(got, want)
        got = GC.gated_conv_1x1(xs[1], w[:, :, 8:], b, scale, offset,
                                bf16=bf16, packed=packed)
        assert torch.equal(got, GC.gated_conv_1x1_plain(
            xs[1], w[:, :, 8:], b, scale, offset, bf16=bf16))
    assert GC.launches == before
