"""Images completed in the window over the window's seconds (all its
requests and all its time: the window closes when the last request sent
in it has its images on the host)."""


def read(r):
    return r.images / r.window_s
