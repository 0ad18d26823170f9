"""Output tokens returned in the window over the window's seconds."""


def read(run):
    return run.window_tokens() / run.seconds
