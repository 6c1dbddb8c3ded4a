"""The whole iteration's share of the card's float32-accurate peak: a
damped-GGN product (``work.ggn_product_flops``) times the window's
iterations, over the traced window at 3xTF32's 165 TFLOP/s."""


def read(run):
    if run.trace is None or run.units == 0:
        return None
    flops = run.units * run.traffic["iterations"] * run.work.ggn_product_flops(run.config)
    return 100.0 * flops / (run.window_s * run.work.PEAK_F32_FLOPS)
