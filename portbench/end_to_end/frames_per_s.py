"""``frames_per_s``: frames completed in the window over the window's
seconds, from the first frame's start to the last one's end (host
clock): all the work over all the time."""


def read(window):
    return len(window.latency_s) / window.window_s
