"""parallel/montecarlo: seconds per batch in which the consuming thread
planned or waited on planning: its own mc.plan_blocks spans (those not
on the mc.lookahead thread) and its mc.lookahead_wait spans, over the
batches planned in the window (the n of every mc.plan_blocks span).
Where nothing plans ahead it reads the whole control plane (host clock;
the program's own spans, runtime/trace, that start in the window)."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    n = sum(s.n for s in spans if s.name == "mc.plan_blocks")
    if n <= 0:
        return None
    exposed = sum(s.t1 - s.t0 for s in spans
                  if s.name == "mc.lookahead_wait"
                  or (s.name == "mc.plan_blocks"
                      and s.thread != "mc.lookahead"))
    return exposed / n
