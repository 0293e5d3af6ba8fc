"""setup_s: process start to the first timed batch (host clock): import,
CUDA init, the kernel library from its build cache, drawing and pressing
the profiles, the Scanner's build and the warm-up."""


def read(run):
    return run.setup_s
