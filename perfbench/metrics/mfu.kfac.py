"""The whole step's share of the card's float32-accurate peak: the work a
KFAC step needs (``work.kfac_step_flops``: the gradient, the covariances,
the refresh's inverse spread over its steps, the apply) times the steps,
over the traced window at 3xTF32's 165 TFLOP/s."""


def read(run):
    if run.trace is None or run.units == 0:
        return None
    flops = run.units * run.work.kfac_step_flops(run.config, run.traffic)
    return 100.0 * flops / (run.window_s * run.work.PEAK_F32_FLOPS)
