"""The UNet serving route's share of its roofline, in %: the least time of
the frame's gated convs (each the larger of its operations at the
configuration's peak and its bytes at the memory rate, counted from the
shapes by ``benchmark.flops``, whatever route computes the conv) over
the device time a frame under the ``bench.net`` span."""

from benchmark import flops


def read(run):
    if run.trace is None:
        return None
    t = run.trace.span_device_s("bench.net") / run.items
    if t <= 0:
        return None
    sh = run.shape
    sites = flops.unet_sites(sh["batch"], sh["h"], sh["w"], **sh["net"])
    least = flops.bound_s(sites, run.cfg["peak_flops"],
                          run.cfg["hbm_bytes_s"])
    return 100.0 * least / t
