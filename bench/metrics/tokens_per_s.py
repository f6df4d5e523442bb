"""Output tokens stamped in the window over the window's seconds."""
UNIT, LAYER, MOVES = "tokens/s", None, None


def read(run):
    w = run.window
    return w["tokens"] / w["seconds"] if w["seconds"] > 0 else None
