"""Process start to the first timed request: imports, the kernels' load
(their build on a checkout's first run), the weights, calibration and the
warm-up."""


def read(run):
    return run.setup_s
