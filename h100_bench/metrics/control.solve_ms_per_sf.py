"""Control plane: ms of the scheduler.solve spans (the slot range solve
inside Scheduler.plan_group, a part of stream.plan) per superframe
planned (host clock; the program's own spans, runtime/trace, that start
in the window)."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    n = sum(s.n for s in spans if s.name == "stream.plan")
    if n <= 0:
        return None
    return sum(s.t1 - s.t0 for s in spans
               if s.name == "scheduler.solve") / n * 1e3
