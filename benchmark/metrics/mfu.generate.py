"""The whole step's share of the card's peak: the analytic FLOPs of an
image through the configuration's streams
(``yardstick/flops.py::flops_per_image``) times the images the traced
run's window completed, over its seconds and the float32 peak."""

from benchmark.yardstick import flops


def read(run, cell):
    cfg = cell.cfg
    per_image = flops.flops_per_image(
        streams=run.counts["streams"], h=cfg["height"], w=cfg["width"],
        t=cfg["max_length"], embed=cfg["embed"],
        layers=tuple(cfg["backbone_layers"]))
    return flops.mfu_pct(per_image * run.counts["images"],
                         run.window_s, cfg["dtype"])
