"""Host-clock ms of the store's step per decode step: the harness's
synchronised spans around `step_fetch_batch`, summed over the window,
over the steps. Nothing to read where no store runs."""


def read(ctx):
    spans = ctx["store_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
