"""Control plane: ms of IqStream's constructor (stream.init: the
scheduler, its first channel allocation and nav messages) per stream
(host clock; the program's own spans, runtime/trace, that start in the
window)."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    inits = [s for s in spans if s.name == "stream.init"]
    if not inits:
        return None
    return sum(s.t1 - s.t0 for s in inits) / len(inits) * 1e3
