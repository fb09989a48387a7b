"""Device ms a step launched while the step thread was in ``read.backward``
from the ``read.net_grad`` instant on: the UNet's backward and the
gather's scatter-add (launched on the autograd engine's thread)."""

from benchmark import spans


def read(run):
    split = spans.split_ms(run, "read.backward", "read.net_grad")
    return None if split is None else split[1]
