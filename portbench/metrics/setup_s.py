"""Seconds from the process's start to the first timed unit: imports, building the
job, the kernels' build on a checkout's first run, the first steps the
reference follows, and warm-up."""


def read(ctx):
    return ctx["setup_s"]
