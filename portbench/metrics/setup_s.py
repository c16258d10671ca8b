"""setup_s: from the process's start to the window's: the import, the
kernels' build or load, the inputs, the warm-up and, for a fit, the
target and the first steps."""


def read(ctx):
    return ctx["setup_s"]
