"""Device ms a step of the operations launched under ATen's convolution
ops, forward and backward (the UNet's and the VGG loss's convs)."""


def _conv(chain):
    return any("convolution" in name for name in chain)


def read(run):
    if run.trace is None:
        return None
    s = run.trace.device_s(_conv)
    return s / run.items * 1e3 if s > 0 else None
