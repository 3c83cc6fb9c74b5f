"""Mbase of every request in the window over the window's wall (host clock)."""


def read(rec):
    if not rec.served:
        return None
    return sum(s.bases for s in rec.served) / 1e6 / rec.window_s
