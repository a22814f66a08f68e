"""runtime/stream: the share of the planner thread's wall time in its
stream.plan, stream.prepare and stream.dispatch spans in which the
thread ran on no CPU, in %: 100 x (wall - thread CPU) / wall, waits for
the interpreter lock, preemption and blocking calls (host clock and
time.thread_time; the program's own spans, runtime/trace, that start
in the window)."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    work = [s for s in spans if s.cpu is not None and s.name in
            ("stream.plan", "stream.prepare", "stream.dispatch")]
    wall = sum(s.t1 - s.t0 for s in work)
    if wall <= 0:
        return None
    return 100.0 * (wall - sum(s.cpu for s in work)) / wall
