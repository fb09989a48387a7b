"""Device ms a step under the program's ``read.unet`` span: the UNet's
differentiable forward (cuDNN convs, BatchNorm, resamples)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "read.unet")
