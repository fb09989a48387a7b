"""The port's training step, eval step and VGG loss run with TF32 off,
whatever the caller's flags, and restore those flags (on the CPU).

A shim around ``F.conv2d`` records ``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` at every convolution of
the forward and, through a hook on its output, of the backward pass.
The flags are process-wide settings, so they can be read and set
without a GPU.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from read_tpu_torch.criterions import vgg as V
from read_tpu_torch.frame import frame_inputs
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.pipelines import texture_pipeline as TP


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def seen(monkeypatch):
    """``{'forward': [flags], 'backward': [flags]}`` at each conv; the
    caller's flags start mixed (cuDNN TF32 on, matmul TF32 off) and are
    put back after the test."""
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    record = {"forward": [], "backward": []}
    real = F.conv2d

    def conv2d(*args, **kw):
        record["forward"].append(_flags())
        out = real(*args, **kw)
        if out.requires_grad:
            out.register_hook(
                lambda g: record["backward"].append(_flags()))
        return out

    monkeypatch.setattr(F, "conv2d", conv2d)
    yield record
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


def _setup(n=1500, hw=(32, 32)):
    xyz, ms = frame_inputs(1, n, hw, focal=30.0)
    target = np.random.default_rng(0).uniform(size=(1, *hw, 3)).astype(
        np.float32)
    cfg = TP.PipelineConfig(crop_size=hw)
    vgg = V.random_vgg_params(torch.Generator().manual_seed(0), device="cpu")
    state, net = TP.create_state(torch.Generator().manual_seed(1), cfg, n,
                                 net=UNet(base_channel=8, num_res=1),
                                 device="cpu")
    batch = {"total_m": torch.from_numpy(ms),
             "target": torch.from_numpy(target)}
    return net, cfg, vgg, state, torch.from_numpy(xyz), batch


def test_train_step_runs_without_tf32_and_restores_flags(seen):
    net, cfg, vgg, state, xyz, batch = _setup()
    TP.make_train_step(net, cfg, vgg)(state, xyz, batch)
    assert _flags() == (True, False)
    # the UNet's convs and VGG's, forward and backward
    assert len(seen["forward"]) > 13 and len(seen["backward"]) > 13
    assert set(seen["forward"]) == set(seen["backward"]) == {(False, False)}


def test_eval_step_runs_without_tf32_and_restores_flags(seen):
    net, cfg, vgg, state, xyz, batch = _setup()
    TP.make_eval_step(net, cfg, vgg)(state, xyz, batch)
    assert _flags() == (True, False)
    assert len(seen["forward"]) > 13
    assert set(seen["forward"]) == {(False, False)}


@pytest.mark.parametrize("mix", [False, True])
def test_vgg_loss_runs_without_tf32_and_restores_flags(seen, mix):
    vgg = V.random_vgg_params(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    pred, target = (torch.from_numpy(rng.uniform(size=(1, 16, 16, 3))
                                     .astype(np.float32)) for _ in range(2))
    loss = (V.vgg_loss_mix(vgg, vgg, pred, target) if mix
            else V.vgg_loss(vgg, pred, target))
    assert torch.isfinite(loss)
    assert _flags() == (True, False)
    assert len(seen["forward"]) == (4 if mix else 2) * 13
    assert set(seen["forward"]) == {(False, False)}
