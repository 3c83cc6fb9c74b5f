"""Reads of every request in the window over the window's wall (host clock)."""


def read(rec):
    if not rec.served:
        return None
    return sum(s.reads for s in rec.served) / rec.window_s
