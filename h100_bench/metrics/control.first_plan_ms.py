"""Control plane: ms of a fresh stream's first plan, the stream.plan
span of its dispatch group 0, per stream (host clock; the program's
own spans, runtime/trace, that start in the window)."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    first = [s for s in spans if s.name == "stream.plan"
             and s.req.endswith(" / group 0")]
    if not first:
        return None
    return sum(s.t1 - s.t0 for s in first) / len(first) * 1e3
