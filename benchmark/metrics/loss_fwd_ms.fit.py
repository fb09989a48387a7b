"""Device ms a step under the program's ``read.loss`` span: Huber, the
VGG features of the output and the target, PSNR."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "read.loss")
