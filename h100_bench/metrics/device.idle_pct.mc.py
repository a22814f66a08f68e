"""Device: the share of the window in which the card ran no operation,
in % (Monte-Carlo cells; torch.profiler's CUDA trace, the union of every kernel's
and copy's interval against the window's host-clock length)."""


def read(run):
    if run.kind != "batch" or not run.ops or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s() / run.window_s)
