"""read_tpu_torch's UNet against flax's, from a JAX-written checkpoint.

Flax ``UNet(base_channel=8, num_res=1, num_classes=3)`` at 32x48, B=2,
with BatchNorm statistics and affines randomised (positive variances) so
the port's BN folding is exercised. The state is written with
``read_tpu.utils.ckpt.save_checkpoint`` and read back with the port's
numpy-only ``ckpt`` + ``convert``. Tolerance: ``atol 5e-4, rtol 1e-3``
(the bound ``tests/test_unet_pallas.py`` holds the Pallas UNet to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.models.unet import _bilinear_up4 as flax_bilinear_up4
from read_tpu.utils import ckpt as JCK
from read_tpu_torch.models import unet as U
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import convert as CV

TOL = dict(atol=5e-4, rtol=1e-3)


def _randomise(rng, variables):
    def leaf(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name == "mean":
            return (rng.normal(size=a.shape) * 0.2).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "bias":
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        return np.array(a)
    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    rng = np.random.default_rng(0)
    b, h, w = 2, 32, 48
    pyr = [rng.normal(size=(b, h // f, w // f, 8)).astype(np.float32)
           for f in (1, 2, 4, 8)]
    net = FlaxUNet(base_channel=8, num_res=1, num_classes=3)
    variables = jax.jit(lambda *p: net.init(jax.random.PRNGKey(0), *p,
                                            train=False))(*pyr)
    variables = _randomise(rng, dict(variables))
    ref = jax.jit(lambda v, *p: net.apply(v, *p, train=False))(
        variables, *pyr)
    texture = rng.uniform(size=(50, 8)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("unet") / "ckpt")
    JCK.save_checkpoint(path, {"params": variables["params"],
                               "batch_stats": variables["batch_stats"],
                               "texture": texture}, config={"dtype": "x"})
    return pyr, {k: np.asarray(v) for k, v in ref.items()}, path, texture


def test_unet_matches_flax_from_checkpoint(jax_case):
    pyr, ref, path, texture = jax_case
    flat, meta = CK.load_checkpoint(path)
    assert meta["config"] == {"dtype": "x"}
    state, tex = CV.variables_from_flat(flat)
    np.testing.assert_array_equal(tex.numpy(), texture)
    net = U.unet_from_state(state)
    assert net.num_classes == 3 and net.Encoder0.num_res == 1
    out = net(*map(torch.from_numpy, pyr))
    assert set(out) == {"im_out", "seg_out"}
    for key in ("im_out", "seg_out"):
        assert tuple(out[key].shape) == ref[key].shape
        np.testing.assert_allclose(out[key].numpy(), ref[key], **TOL)


def test_unet_bf16_operands_track_f32(jax_case):
    """bf16 conv/matmul operands, f32 accumulation: within bf16 rounding
    of the f32 flax output (atol 2e-2, rtol 5e-2)."""
    pyr, ref, path, _ = jax_case
    state, _ = CV.variables_from_flat(CK.load_checkpoint(path)[0])
    out = U.unet_from_state(state)(*map(torch.from_numpy, pyr),
                                   operands="bf16")["im_out"].numpy()
    np.testing.assert_allclose(out, ref["im_out"], atol=2e-2, rtol=5e-2)
    assert float(np.abs(out - ref["im_out"]).max()) > 0


def test_convert_round_trip_is_bit_exact(jax_case):
    _, _, path, _ = jax_case
    flat, _ = CK.load_checkpoint(path)
    net_flat = {k: v for k, v in flat.items()
                if k.split("/")[0] in ("params", "batch_stats", "texture")}
    back = CV.flat_from_variables(*CV.variables_from_flat(flat))
    assert set(back) == set(net_flat)
    for key, arr in net_flat.items():
        assert back[key].dtype == arr.dtype
        np.testing.assert_array_equal(back[key], arr)


def test_port_checkpoint_loads_in_read_tpu(tmp_path):
    """A checkpoint the port writes (no JAX) reads back through the JAX
    package's loader with the same arrays."""
    net = U.UNet(base_channel=8, num_res=1).init_weights(
        torch.Generator().manual_seed(0))
    flat = CV.flat_from_variables(net.state_dict(), torch.rand(10, 8))
    path = CK.save_checkpoint(str(tmp_path / "c"), flat,
                              config={"raster_method": "pallas"})
    flat_j, meta = JCK.load_checkpoint(path)
    assert meta["config"]["raster_method"] == "pallas"
    assert set(flat_j) == set(flat)
    for key in flat:
        np.testing.assert_array_equal(flat_j[key], flat[key])


def test_bilinear_up4_matches_jax_image_resize():
    """x4 half-pixel bilinear: F.interpolate(align_corners=False) vs
    jax.image.resize, edges included (both clamp to the border)."""
    x = np.random.default_rng(1).normal(size=(2, 5, 7, 3)).astype(
        np.float32)
    want = np.asarray(flax_bilinear_up4(jnp.asarray(x)))
    got = U._bilinear_up4(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-6)
    np.testing.assert_allclose(got[:, :, -2:], want[:, :, -2:], atol=1e-6)


def test_nearest_resamples_match_flax():
    from read_tpu.models.unet import _nearest_down, _nearest_up
    x = np.random.default_rng(2).normal(size=(2, 8, 12, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        U._nearest_down(torch.from_numpy(x), 4).numpy(),
        np.asarray(_nearest_down(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(
        U._nearest_up(torch.from_numpy(x), 2).numpy(),
        np.asarray(_nearest_up(jnp.asarray(x), 2)))


def test_train_mode_raises():
    net = U.UNet(base_channel=8, num_res=1)
    x = [torch.zeros(1, 16 // f, 16 // f, 8) for f in (1, 2, 4, 8)]
    with pytest.raises(NotImplementedError):
        net(*x, train=True)
