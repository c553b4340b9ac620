"""setup_s: process start to the first timed tick (imports, nvcc in a
checkout's first run, loading the built kernels, building the inputs on
the card, warm-up), host clock."""


def read(rd):
    return rd.setup_s
