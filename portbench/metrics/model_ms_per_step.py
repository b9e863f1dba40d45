"""Host-clock ms of the model's decode per step: the harness's
synchronised spans around `decode_step`, summed over the window, over
the steps."""


def read(ctx):
    spans = ctx["model_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
