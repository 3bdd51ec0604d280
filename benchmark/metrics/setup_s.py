"""Seconds from the start of the run to the first timed dispatch: imports,
the kernel library, the scene, the program's warm-up and capture, and one
image of replays (host clock)."""


def read(rec):
    return rec["setup_s"]
