"""Device ms a step of the descriptor table's own work: the gather
(``read.gather``), its scatter-add backward (``read.gather_bwd``, on the
autograd engine's thread) and RMSprop with the table's update
(``read.rmsprop``)."""

from benchmark import spans

PARTS = ("read.gather", "read.gather_bwd", "read.rmsprop")


def read(run):
    parts = [spans.span_ms(run, name) for name in PARTS]
    return None if None in parts else sum(parts)
