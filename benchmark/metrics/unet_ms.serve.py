"""Device ms a frame under the ``bench.net`` span: the UNet's serving
route (K2, K3, K4 and the glue between them)."""


def read(run):
    if run.trace is None:
        return None
    s = run.trace.span_device_s("bench.net")
    return s / run.items * 1e3 if s > 0 else None
