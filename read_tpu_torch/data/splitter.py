"""Train/val split policies.

The port's copy of ``read_tpu/data/splitter.py``: ``split_by_ratio``,
``split_by_step`` (val holds frame 0 and every ``val_step``-th frame),
``split_by_step100``, ``eval_all`` (everything is val) and
``get_splitter``, the registry lookup by name.

Each splitter takes parallel lists and returns ``(train_lists, val_lists)``
where each side is a list of the same parallel structure.
"""

from __future__ import annotations

import numpy as np

__all__ = ["split_by_ratio", "split_by_step", "split_by_step100",
           "eval_all", "get_splitter"]


def _check(lists):
    assert len(lists) > 0
    n = len(lists[0])
    assert all(len(x) == n for x in lists), "parallel lists length mismatch"
    return n


def split_by_ratio(lists, train_ratio=0.9, seed=None):
    """Random split (``splitter.py:6-23``)."""
    n = _check(lists)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_train = int(n * train_ratio)
    tr = sorted(perm[:n_train].tolist())
    va = sorted(perm[n_train:].tolist())
    train = [[x[i] for i in tr] for x in lists]
    val = [[x[i] for i in va] for x in lists]
    return train, val


def split_by_step(lists, val_step=10, train_drop=0):
    """Every ``val_step``-th frame goes to val; optionally drop a margin of
    ``train_drop`` frames around each val frame from train
    (``splitter.py:52-72``)."""
    n = _check(lists)
    val_idx = set(range(0, n, val_step))
    drop = set()
    for i in val_idx:
        for d in range(1, train_drop + 1):
            drop.add(i - d)
            drop.add(i + d)
    tr = [i for i in range(n) if i not in val_idx and i not in drop]
    va = sorted(val_idx)
    train = [[x[i] for i in tr] for x in lists]
    val = [[x[i] for i in va] for x in lists]
    return train, val


def split_by_step100(lists, val_step=10):
    """100-frame blocks: within each block the first ``val_step`` frames go
    to val and the rest to train (``splitter.py:28-48`` behavior)."""
    n = _check(lists)
    tr, va = [], []
    for i in range(n):
        if (i % 100) < val_step:
            va.append(i)
        else:
            tr.append(i)
    train = [[x[i] for i in tr] for x in lists]
    val = [[x[i] for i in va] for x in lists]
    return train, val


def eval_all(lists, **_kwargs):
    """Everything is val (the ``--eval_all`` policy the reference names
    but never defines)."""
    _check(lists)
    return [[] for _ in lists], [list(x) for x in lists]


_REGISTRY = {
    "split_by_ratio": split_by_ratio,
    "split_by_step": split_by_step,
    "split_by_step100": split_by_step100,
    "eval_all": eval_all,
}


def get_splitter(name: str):
    """Explicit registry lookup — replaces the reference's pydoc/eval
    config-as-code (``utils/arguments.py:108-153``)."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown splitter {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
