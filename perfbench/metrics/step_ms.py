"""step_ms: the window's wall time over the model steps completed in it.
The window runs from its start until the forecast in flight at its close
can be read and is released: every forecast's build, steps, output and
release, and whatever the host does between them, fall inside it."""


def read(record):
    steps = record.steps
    if not steps:
        return None
    return 1e3 * record.window_s / steps
