"""Device ms per image inside the spans around the UNet calls, all steps,
in one eager run of a request."""


def read(r):
    if r.spans is None:
        return None
    ns = sum(r.spans.busy(s, e) for s, e in r.spans.spans_named("unet"))
    return ns / 1e6 / r.batch if ns else None
