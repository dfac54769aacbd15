"""publish_ms.live: the mean host time a block of the pump's publish
(``radio.FrontEnd._publish``: the spectrum row's copy, the scan of the
slots for subscribed receivers, the gather of their rows), in ms, over
the blocks whose publish began in the window, from the program's flight
recorder (``webradio_tpu_torch.trace``). Layer: topology pump."""


def read(run):
    try:
        from webradio_tpu_torch import trace
    except ImportError:
        return None
    got = trace.window("publish0", *run.window)
    if got is None:
        return None
    rec, rows = got
    end = rec.column(rows, "publish1")
    spans = (end - rec.column(rows, "publish0"))[end > 0]
    return float(spans.mean()) / 1e6 if spans.size else None
