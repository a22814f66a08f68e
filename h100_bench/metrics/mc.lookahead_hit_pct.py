"""parallel/montecarlo: the share of the window's batch calls that took
planes a lookahead had planned, in %: 100 x the n of the
mc.lookahead_wait spans (1 a hit, 0 a discard) over the batch calls,
the hits and the mc.plan_blocks spans not on the mc.lookahead thread
(a call that discards a lookahead then plans on its own thread, and
counts once).  0 where nothing plans ahead (the program's own spans,
runtime/trace, that start in the window)."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    hits = sum(s.n for s in spans if s.name == "mc.lookahead_wait")
    calls = hits + sum(1 for s in spans if s.name == "mc.plan_blocks"
                       and s.thread != "mc.lookahead")
    if calls <= 0:
        return None
    return 100.0 * hits / calls
