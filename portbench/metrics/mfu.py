"""The whole generation's share of the chip's peak, in %: the least
compute time of one image's work at the published peak of each layer's
precision (``counts.py``), times the images completed in the (untraced)
window, over its seconds."""


def read(r):
    return 100.0 * r.counts["generation_least_compute_s"] * r.images \
        / r.window_s
