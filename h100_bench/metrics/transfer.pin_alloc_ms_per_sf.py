"""Transfer: ms of the transfer.pin_alloc spans (the pinned staging of a
launch's parameter planes and the fresh pinned output buffer of each
dispatch group) per superframe dispatched (host clock; the program's
own spans, runtime/trace, that start in the window).  0 where the
window dispatched without a pinned allocation."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    n = sum(s.n for s in spans if s.name == "stream.dispatch")
    if n <= 0:
        return None
    return sum(s.t1 - s.t0 for s in spans
               if s.name == "transfer.pin_alloc") / n * 1e3
