"""Process start to the first token of the window: imports, the engine and
its pool, the weights, the kernels' build, opened sessions and warm-up."""
UNIT, LAYER, MOVES = "s", None, None


def read(run):
    return run.setup_s
