"""Packing: the share of the superframes prepared whose parameter planes
were built on the card, in %: 100 x the n of the packing.card_build
spans (the build_params path of launch.pack_group, a child of
stream.prepare) over the n of the stream.prepare spans (the program's
own spans, runtime/trace, that start in the window).  A card build
counts where its group's stream.prepare is counted, and only there: a
prepare that starts just before the window leaves out its card build,
one that starts just before its end keeps it.  0
where every group was built on the host (blocks split past the kernel's
Q24 range, or a tree without the card build); None where nothing was
prepared."""


def read(run):
    try:
        from pluto_gps_sim_tpu_torch.runtime import trace
    except ImportError:          # a program that records no spans
        return None
    spans = trace.spans(run.t0, run.t1)
    prepared = {s.req: s.n for s in spans if s.name == "stream.prepare"}
    n = sum(prepared.values())
    if n <= 0:
        return None
    # a card build starts inside its prepare, so after run.t0
    return 100.0 * sum(s.n for s in trace.spans(run.t0)
                       if s.name == "packing.card_build"
                       and s.req in prepared) / n
