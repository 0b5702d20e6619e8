"""What the readers of the LM cells share: the device time the traced
run's recorded pass gave the port's spans (``obs.attribute``)."""


def span_device_ms(trace, name, per=None):
    """Busy device milliseconds inside the spans named ``name``: over
    ``per`` steps (None: a span), or None where the span was not recorded
    or given no device time (a port without it, or a run off the card)."""
    stats = (trace.get("spans") or {}).get(name)
    if not stats or not stats["count"] or stats["device_s"] is None:
        return None
    return stats["device_s"] * 1e3 / (per or stats["count"])
