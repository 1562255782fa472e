"""Device ms per image inside the span around the VAE decode, in one
eager run of a request."""


def read(r):
    if r.spans is None:
        return None
    ns = sum(r.spans.busy(s, e) for s, e in r.spans.spans_named("vae"))
    return ns / 1e6 / r.batch if ns else None
