"""Seconds from the new collection to the first answer: the recipe's build and
its warm trial, which builds the SpMV plan and captures the compiled loop
(the harness's span)."""


def read(r):
    spans = r.spans.get("sparse.first_trial_s")
    return sum(spans) if spans else None
