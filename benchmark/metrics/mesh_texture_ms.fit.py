"""Device ms a step of the mesh tables' own work: their bilinear sample at
every level (``read.mesh_sample``), its backward (``read.backward`` from
the ``read.mesh_grad`` instant on: the four ``index_select`` backwards'
scatter-adds into the tables, on the autograd engine's thread) and
RMSprop with the tables' update (``read.rmsprop``)."""

from benchmark import spans


def read(run):
    split = spans.split_ms(run, "read.backward", "read.mesh_grad")
    parts = [spans.span_ms(run, "read.mesh_sample"),
             None if split is None else split[1],
             spans.span_ms(run, "read.rmsprop")]
    return None if None in parts else sum(parts)
