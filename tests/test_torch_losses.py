"""read_tpu_torch's losses and VGG perceptual loss against read_tpu's.

Same numpy inputs (NHWC, 32x32) through ``read_tpu.criterions`` and
``read_tpu_torch.criterions`` on the CPU. The VGG runs JAX's own
``random_vgg_params(0)``, carried across as numpy arrays. Tolerances:
values rtol 1e-4 (float32 convolutions in another summation order);
gradients atol 1e-5 * max|g|.

PyTorch's oneDNN CPU convolution is switched off in this module: its
backward loses up to 4e-4 * max|g| on the caffe-scaled VGG inputs
(checked against float64), where PyTorch's own CPU convolution and
JAX's hold ~2e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.criterions import losses as JL
from read_tpu.criterions import vgg as JV
from read_tpu_torch.criterions import losses as L
from read_tpu_torch.criterions import vgg as V
from read_tpu_torch.utils import convert as CV

VALUE = dict(rtol=1e-4, atol=0.0)


@pytest.fixture(scope="module", autouse=True)
def native_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _images(seed=0, b=2, h=32, w=32):
    rng = np.random.default_rng(seed)
    pred = rng.normal(0.5, 0.8, size=(b, h, w, 3)).astype(np.float32)
    target = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    target[:, :6] = 0.0          # a black border: empty for partialconv
    return pred, target


@pytest.fixture(scope="module")
def vgg_params():
    jp = JV.random_vgg_params(0)
    return jp, CV.vgg_params_from_numpy([(np.asarray(w), np.asarray(b))
                                         for w, b in jp])


@pytest.mark.parametrize("per_item", [False, True])
@pytest.mark.parametrize("name", ["huber_loss", "psnr", "ssim"])
def test_pixel_losses_match_jax(name, per_item):
    pred, target = _images()
    want = getattr(JL, name)(jnp.asarray(pred), jnp.asarray(target),
                             per_item=per_item)
    got = getattr(L, name)(torch.from_numpy(pred), torch.from_numpy(target),
                           per_item=per_item)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUE)


def test_ssim_clamps_near_constant_windows():
    """Near-uniform windows (black crops) must score within [-1, 1]: the
    variance and covariance clamps of read_tpu's ssim."""
    pred = np.full((1, 24, 24, 3), 1e-3, np.float32)
    target = np.zeros((1, 24, 24, 3), np.float32)
    target[:, 12:] = 1e-3
    got = L.ssim(torch.from_numpy(pred), torch.from_numpy(target),
                 per_item=True)
    want = JL.ssim(jnp.asarray(pred), jnp.asarray(target), per_item=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUE)
    assert float(got.abs().max()) <= 1.0


def test_segmentation_and_background_losses_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 16, 16, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=(2, 16, 16)).astype(np.int32)
    pred, _ = _images(2, h=16, w=16)
    mask = (rng.uniform(size=(2, 16, 16, 1)) > 0.4).astype(np.float32)
    pairs = [
        (L.cross_entropy_ignore0(torch.from_numpy(logits),
                                 torch.from_numpy(labels)),
         JL.cross_entropy_ignore0(jnp.asarray(logits), jnp.asarray(labels))),
        (L.masked_background_loss(torch.from_numpy(pred),
                                  torch.from_numpy(mask)),
         JL.masked_background_loss(jnp.asarray(pred), jnp.asarray(mask))),
        (L.l1_loss(torch.from_numpy(pred), torch.from_numpy(pred * 0.5)),
         JL.l1_loss(jnp.asarray(pred), jnp.asarray(pred * 0.5))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUE)
    # every label ignored: the count clamps to 1, the loss is 0
    zero = L.cross_entropy_ignore0(torch.from_numpy(logits),
                                   torch.zeros(2, 16, 16, dtype=torch.int32))
    assert float(zero) == 0.0


@pytest.mark.parametrize("kind", ["caffe", "pytorch", "partialconv", "mix"])
def test_vgg_loss_and_grad_match_jax(vgg_params, kind):
    """Value (per batch and per item) and d loss / d pred."""
    jp, tp = vgg_params
    pred, target = _images(3)

    def jax_loss(p, per_item=False):
        t = jnp.asarray(target)
        if kind == "mix":
            return JV.vgg_loss_mix(jp, jp, p, t, per_item=per_item)
        return JV.vgg_loss(jp, p, t,
                           backend="pytorch" if kind == "pytorch" else
                           "caffe", partialconv=kind == "partialconv",
                           per_item=per_item)

    def torch_loss(p, per_item=False):
        t = torch.from_numpy(target)
        if kind == "mix":
            return V.vgg_loss_mix(tp, tp, p, t, per_item=per_item)
        return V.vgg_loss(tp, p, t,
                          backend="pytorch" if kind == "pytorch" else
                          "caffe", partialconv=kind == "partialconv",
                          per_item=per_item)

    (want, want_g), want_items = jax.jit(
        lambda p: (jax.value_and_grad(jax_loss)(p), jax_loss(p, True)))(
            jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    got = torch_loss(p)
    (got_g,) = torch.autograd.grad(got, [p])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **VALUE)
    with torch.no_grad():
        items = torch_loss(torch.from_numpy(pred), True)
    np.testing.assert_allclose(items.numpy(), np.asarray(want_items),
                               **VALUE)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0,
                               atol=1e-5 * float(np.abs(want_g).max()))


def test_vgg_target_side_has_no_graph(vgg_params):
    _, tp = vgg_params
    pred, target = _images(4, b=1, h=16, w=16)
    t = torch.from_numpy(target).requires_grad_()
    loss = V.vgg_loss(tp, torch.from_numpy(pred).requires_grad_(), t)
    loss.backward()
    assert t.grad is None


def test_vgg_params_random_and_loaded(tmp_path, vgg_params):
    """The port's own random init has VGG19's shapes and He-normal
    scale; a .npz of JAX's params loads back bit for bit."""
    jp, _ = vgg_params
    params = V.random_vgg_params(torch.Generator().manual_seed(0))
    cin = 3
    for (w, b), cout in zip(params, V.VGG_CHANNELS):
        assert tuple(w.shape) == (3, 3, cin, cout) and float(b.abs().max()) \
            == 0.0
        assert abs(float(w.std()) / np.sqrt(2.0 / (9 * cin)) - 1) < 0.1
        cin = cout
    path = str(tmp_path / "vgg.npz")
    np.savez(path, **{f"conv{i}_{k}": np.asarray(a) for i, wb in
                      enumerate(jp) for k, a in zip("wb", wb)})
    for (w, b), (jw, jb) in zip(V.load_vgg_params(path), jp):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_vgg_params_load_pth_state_dict(tmp_path, vgg_params):
    """A torchvision-style VGG19 state dict (``features.{i}``, OIHW, a
    ReLU or pool between convs) loads as HWIO bit for bit; a pickled
    object that is not plain tensors is refused."""
    jp, _ = vgg_params
    sd, i = {}, 0
    for w, b in jp:
        sd[f"features.{i}.weight"] = torch.from_numpy(
            np.array(w)).permute(3, 2, 0, 1).contiguous()
        sd[f"features.{i}.bias"] = torch.from_numpy(np.array(b))
        i += 2 if i % 5 else 3
    path = str(tmp_path / "vgg.pth")
    torch.save(sd, path)
    for (w, b), (jw, jb) in zip(V.load_vgg_params(path), jp):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    torch.save(torch.nn.Conv2d(3, 64, 3), path)
    with pytest.raises(Exception, match="[Ww]eights"):
        V.load_vgg_params(path)
