"""step_ms: the whole measured window over the fit steps completed in it
(host clock; every step ends in float(loss))."""


def read(ctx):
    w = ctx["window"]
    return 1000.0 * w.elapsed / w.count
