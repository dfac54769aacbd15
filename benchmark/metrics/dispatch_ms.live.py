"""dispatch_ms.live: the mean host time of one
``HostPipeline.process_host`` call (the staging copy, the H2D copy's
launch, the graph replay's launch), in ms, over the blocks dispatched in
the window. Layer: step host wrapper and graphs
(``pipeline.frontend.HostPipeline.process_host``, ``pipeline.graph``)."""


def read(run):
    t0, t1 = run.window
    spans = [b.dispatch[1] - b.dispatch[0] for b in run.dispatched
             if t0 <= b.dispatch[0] < t1]
    return 1e3 * sum(spans) / len(spans) if spans else None
