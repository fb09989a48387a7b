"""Device ms a frame under the program's ``read.gather`` span: the
descriptor gather of each pyramid level in ``build_pyramid``."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "read.gather")
