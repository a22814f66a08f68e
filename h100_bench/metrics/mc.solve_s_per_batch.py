"""parallel/montecarlo: seconds of the batched range solves inside
MonteCarloBatch.plan_blocks (mc.solve: solve_ranges_batch_lean and the
boundary allocation solves) per batch planned (host clock; the
program's own spans, runtime/trace, that start in the window)."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    n = sum(s.n for s in spans if s.name == "mc.plan_blocks")
    if n <= 0:
        return None
    return sum(s.t1 - s.t0 for s in spans if s.name == "mc.solve") / n
