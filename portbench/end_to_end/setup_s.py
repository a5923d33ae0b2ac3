"""``setup_s``: seconds from the process's start to the first timed
frame: imports, the card, the inputs made from the seed, the program's
kernels loaded (built on a checkout's first run) and the warm-up
frames."""


def read(window):
    return window.setup_s
