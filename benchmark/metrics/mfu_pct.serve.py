"""The frame's share of the card's peak, in %: the UNet's conv operations
of one frame (``benchmark.flops``, each conv's least form) over the
window's seconds a frame times the configuration's peak."""

from benchmark import flops


def read(run):
    if not run.item_s or run.item_s <= 0:
        return None
    sh = run.shape
    ops = flops.total_flops(flops.unet_sites(sh["batch"], sh["h"], sh["w"],
                                             **sh["net"]))
    return 100.0 * ops / (run.item_s * run.cfg["peak_flops"])
