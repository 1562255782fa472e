"""Host time of a request, in ms: the median over the window's requests
of each ``generate`` call's wall time minus the device time of its CUDA
graph replay (timing events around the replay in the unprofiled window
of a traced run). What is left is the serving engine's path off the
graph: tokenize, noise, copy-in, the launch, the images to numpy."""

import statistics


def read(r):
    if not r.graph_s:
        return None
    return 1e3 * statistics.median(
        w - g for w, g in zip(r.latencies_s, r.graph_s))
