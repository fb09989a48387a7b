"""Device ms a frame under the program's ``read.raster`` span: the
z-buffer and the pyramid pass of ``build_pyramid`` (K5 and the pass)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "read.raster")
