"""The share of the window's wall time in which no CUDA graph replay ran
on the device, in %: 1 - the replays' device time (timing events, the
unprofiled window of a traced run) over the window's seconds. A replay
runs its kernels back to back, so its span counts as busy; the small
device work outside it (noise, copy-in, the images' copy to the host)
counts as idle. ``device.busy_s`` / ``window_s`` give the profiler's own
reading of a traced stretch, its host overhead in it."""


def read(r):
    if not r.graph_s:
        return None
    return 100.0 * (1.0 - sum(r.graph_s) / r.window_s)
