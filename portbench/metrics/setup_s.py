"""Seconds from the process's start to the window's start: imports, the
kernels' build (none once built), weights, calibration, deploy, capture
and one warm request."""


def read(r):
    return r.setup_s
