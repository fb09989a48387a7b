"""The triangle raster's share of its roofline, in %: the least time of a
step's rasters (``benchmark.mesh_flops``: each input and output byte
once, the function's operations, at the configuration's peak and memory
rate) over the device time a step under ``read.mesh_raster``."""

from benchmark import mesh_flops, spans


def read(run):
    t_ms = spans.span_ms(run, "read.mesh_raster")
    if not t_ms or "mesh" not in run.shape:
        return None
    sh = run.shape
    least = mesh_flops.step_bound_s(*sh["mesh"], sh["batch"], sh["h"],
                                    sh["w"], sh["levels"],
                                    run.cfg["peak_flops"],
                                    run.cfg["hbm_bytes_s"])
    return 100.0 * least * 1e3 / t_ms
