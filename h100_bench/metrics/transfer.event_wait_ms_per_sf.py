"""Transfer: ms the consumer waits on a dispatched group's CUDA event,
its kernel and D2H copy (transfer.event_wait), per superframe received
(host clock; the program's own spans, runtime/trace, that start in the
window).  High when the card's copies set the pace."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    waits = [s for s in spans if s.name == "transfer.event_wait"]
    n = sum(s.n for s in waits)
    if n <= 0:
        return None
    return sum(s.t1 - s.t0 for s in waits) / n * 1e3
