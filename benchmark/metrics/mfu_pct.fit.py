"""The fitting step's share of the card's peak, in %: the model operations
of one step (``benchmark.flops.fit_step_flops``: the UNet forward three
times, the VGG forward on output and target and the output's input
gradient) over the window's seconds a step times the configuration's
peak."""

from benchmark import flops


def read(run):
    if not run.item_s or run.item_s <= 0:
        return None
    sh = run.shape
    ops = flops.fit_step_flops(sh["batch"], sh["h"], sh["w"], sh["net"])
    return 100.0 * ops / (run.item_s * run.cfg["peak_flops"])
