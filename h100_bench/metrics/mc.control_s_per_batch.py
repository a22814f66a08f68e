"""parallel/montecarlo: seconds of MonteCarloBatch.plan_blocks, the
batched control plane, per batch (host clock, the benchmark's span on
the run's batch instance)."""


def read(run):
    seconds, _, calls = run.rec.total("mc.plan_blocks")
    if calls <= 0:
        return None
    return seconds / calls
