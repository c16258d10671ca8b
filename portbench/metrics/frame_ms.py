"""frame_ms: the whole measured window over the frames completed in it
(host clock, every frame synchronised)."""


def read(ctx):
    w = ctx["window"]
    return 1000.0 * w.elapsed / w.count
