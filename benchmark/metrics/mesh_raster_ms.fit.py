"""Device ms a step under the program's ``read.mesh_raster`` span: the
triangle raster of every view at every level and the perspective-correct
uv maps (``texture_pipeline._mesh_pyramid``)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "read.mesh_raster")
