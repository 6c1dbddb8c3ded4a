"""Share of its roofline of the conv input-covariance kernel
(``cov_tiles_kernel`` and ``reduce_mirror_kernel``): the least time of the
covariances of the convs the kernel takes (the configuration's family's
``covariance_kernel_convs``, each by ``work.conv_cov_bound``) times the
factor passes in the window, over the kernels' device time in the trace.
Nothing to read without those kernels in the trace."""

KERNELS = ("cov_tiles_kernel", "reduce_mirror_kernel")


def read(run):
    if run.trace is None:
        return None
    seconds = sum(run.trace.time_of(k) for k in KERNELS)
    passes = len(run.spans.get("factor_pass", []))
    if seconds <= 0 or passes == 0:
        return None
    cfg = run.config
    convs = run.work.family(cfg).covariance_kernel_convs(cfg)
    least = sum(run.work.conv_cov_bound(cfg["batch_size"], c)[0] for c in convs)
    return 100.0 * passes * least / seconds
