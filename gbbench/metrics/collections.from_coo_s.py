"""Seconds of ``Matrix.from_coo`` on the generated host COO (the harness's span)."""


def read(r):
    spans = r.spans.get("collections.from_coo_s")
    return sum(spans) if spans else None
