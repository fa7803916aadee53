"""Host milliseconds an eager DSL statement takes from its call to its return,
over the window's statements (the harness's spans around each statement of
an eager recipe)."""


def read(r):
    spans = r.spans.get("stmt")
    return 1e3 * sum(spans) / len(spans) if spans else None
