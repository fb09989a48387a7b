"""Device ms a frame under the ``bench.pyramid`` span: the raster (K5 and
the pyramid pass) and the descriptor gather of ``NeuralRenderer.pyramid``."""


def read(run):
    if run.trace is None:
        return None
    s = run.trace.span_device_s("bench.pyramid")
    return s / run.items * 1e3 if s > 0 else None
