"""Control plane: ms of the planner thread's stream.plan span (the
Scheduler.plan_group or plan call of a dispatch group) per superframe
planned (host clock; the program's own spans, runtime/trace, that start
in the window)."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    plans = [s for s in spans if s.name == "stream.plan"]
    n = sum(s.n for s in plans)
    if n <= 0:
        return None
    return sum(s.t1 - s.t0 for s in plans) / n * 1e3
