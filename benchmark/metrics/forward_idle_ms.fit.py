"""Ms a step in which the device ran nothing while the step thread was in
the program's ``read.forward`` span (raster, gather, UNet, losses)."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run, "read.forward")
