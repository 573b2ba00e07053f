"""Set-up seconds: from the process's start to the window's first instant
(loading, the kernels' build or load, the weights, warming every shape)."""


def read(record):
    return record.setup_s
