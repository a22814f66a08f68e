"""Packing: ms of the planner thread's packing.split span (the
split_plan calls of a dispatch group whose blocks pass the kernel's Q24
range, a child of stream.prepare) per superframe split (host clock; the
program's own spans, runtime/trace, that start in the window).  None
where the program records no such span: a tree without it, or a cell
whose blocks are not split."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    split = [s for s in spans if s.name == "packing.split"]
    n = sum(s.n for s in split)
    if n <= 0:
        return None
    return sum(s.t1 - s.t0 for s in split) / n * 1e3
