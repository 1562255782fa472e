"""The UNet's share of its roofline, in %: its least time per image, the
sum over its layers of the larger of operations over the peak of the
layer's precision and bytes over 3.35 TB/s (``counts.py``), over the
device time per image inside the UNet spans."""


def read(r):
    if r.spans is None:
        return None
    ns = sum(r.spans.busy(s, e) for s, e in r.spans.spans_named("unet"))
    if not ns:
        return None
    return 100.0 * r.counts["unet_least_roofline_s"] / (ns / 1e9 / r.batch)
