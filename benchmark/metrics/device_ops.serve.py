"""Device operations (kernels, copies, sets) a frame in the traced slice;
each kernel of a CUDA graph's replay counts."""

from benchmark import spans


def read(run):
    return spans.device_ops(run)
