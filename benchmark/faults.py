"""Faults planted under the timed path, to show that ``correct`` catches
them: the step that returns its state unchanged, the half batch, and an
answer altered where it is produced (a frame's pixels; the table's
update twice over). :func:`planted` puts one in the program for the
length of a ``with`` block; the tests and ``benchmark.calibrate`` use
it. A benchmark run never does.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

__all__ = ["FAULTS", "planted"]


def _unchanged(step):
    """The step returns its state unchanged (but for its count)."""
    def run(state, xyz, batch):
        _, metrics = step(state, xyz, batch)
        return dataclasses.replace(state, step=state.step + 1), metrics
    return run


def _half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def run(state, xyz, batch):
        b = batch["target"].shape[0]
        return step(state, xyz, {k: v[:max(1, b // 2)]
                                 for k, v in batch.items()})
    return run


def _texture_doubled(step):
    """The table's update applied twice over."""
    def run(state, xyz, batch):
        new, metrics = step(state, xyz, batch)
        tex = tuple(2 * n - o for n, o in zip(new.texture, state.texture))
        return dataclasses.replace(new, texture=tex), metrics
    return run


def _frame_altered(infer):
    """A 4 x 4 patch of every frame 0.05 brighter."""
    def run(self, *a, **k):
        img = infer(self, *a, **k)
        img[:4, :4] = np.clip(img[:4, :4] + 0.05, 0.0, 1.0)
        return img
    return run


# name -> (kind it breaks, wrapper)
FAULTS = {"unchanged": ("fit", _unchanged),
          "half_batch": ("fit", _half_batch),
          "texture_doubled": ("fit", _texture_doubled),
          "frame_altered": ("view", _frame_altered)}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` in place inside the block."""
    kind, wrap = FAULTS[name]
    if kind == "fit":
        from read_tpu_torch.pipelines import texture_pipeline as owner
        attr = "make_train_step"
        make = owner.make_train_step

        def patched(*a, **k):
            return wrap(make(*a, **k))
    else:
        from read_tpu_torch.render import NeuralRenderer as owner
        attr = "infer"
        patched = wrap(owner.infer)
    saved = getattr(owner, attr)
    setattr(owner, attr, patched)
    try:
        yield
    finally:
        setattr(owner, attr, saved)
