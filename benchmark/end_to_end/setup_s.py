"""Seconds from the process's start to the window's start: loading, the
scene, the program's packs and builds, warm-up and captures."""


def read(values):
    return values["setup_s"]
