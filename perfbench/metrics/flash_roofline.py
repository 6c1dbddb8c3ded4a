"""Share of their roofline of the three flash-attention kernels: the least
time of each launch at the configuration's ``[B, H, T, hd]`` (its family's
``attention_shape``, each launch by ``work.flash_bound``), summed over the
launches the trace holds, over their summed device time. Nothing to read
without those kernels in the trace."""

KERNELS = {"fwd": "flash_fwd_kernel", "bwd_dkv": "flash_bwd_dkv_kernel",
           "bwd_dq": "flash_bwd_dq_kernel"}


def read(run):
    if run.trace is None:
        return None
    seconds = sum(run.trace.time_of(name) for name in KERNELS.values())
    if seconds <= 0:
        return None
    shape = run.work.family(run.config).attention_shape(run.config)
    least = sum(run.trace.launches_of(name) * run.work.flash_bound(k, *shape, 4)[0]
                for k, name in KERNELS.items())
    return 100.0 * least / seconds
