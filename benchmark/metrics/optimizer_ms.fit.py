"""Device ms a step under the program's ``read.optimizer`` span: the
gradient guards, RMSprop on the table, Adam on the net, the updates."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "read.optimizer")
