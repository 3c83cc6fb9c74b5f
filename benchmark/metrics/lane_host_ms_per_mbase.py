"""Host ms per Mbase of the long-read lane (FpClassifier.process_long_many:
chunk rows, the group launches, the fetch, the host fold) over the traced
window."""


def read(rec):
    t = rec.trace
    if t is None or not t.host_s.get("lane") or not rec.served:
        return None
    return 1e3 * t.host_s["lane"] / (sum(s.bases for s in rec.served) / 1e6)
