"""Process start to the window's start: DB build, input pool, classifier,
kernel build (first run in a checkout) and one warm-up request."""


def read(rec):
    return rec.setup_s
