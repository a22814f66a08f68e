"""Packing: ms of the planner thread's stream.prepare span
(IqStream._prepare_group: pack_plan, build_group_params, the C/A tables
and the superframe map) per superframe prepared (host clock; the
program's own spans, runtime/trace, that start in the window)."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    prep = [s for s in spans if s.name == "stream.prepare"]
    n = sum(s.n for s in prep)
    if n <= 0:
        return None
    return sum(s.t1 - s.t0 for s in prep) / n * 1e3
