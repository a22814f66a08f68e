"""Packing: seconds of the packing.split spans under
MonteCarloBatch.plan_blocks (split_plan of a batch whose blocks pass
the kernel's Q24 range, a child of mc.build, on whichever thread plans)
per batch planned (host clock; the program's own spans, runtime/trace,
that start in the window).  None where the program records no such
span: a tree whose batch does not split, or a cell whose blocks fit the
kernel's range."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    split = [s for s in spans
             if s.name == "packing.split" and s.parent == "mc.build"]
    n = sum(s.n for s in spans if s.name == "mc.plan_blocks")
    if not split or n <= 0:
        return None
    return sum(s.t1 - s.t0 for s in split) / n
