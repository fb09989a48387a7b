"""Ms a step in which the device ran nothing while the step thread was in
the program's ``read.backward`` span (``torch.autograd.grad``)."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, "read.backward")
