"""Camera paths of every frame or pass completed in the window, in
millions, over the window's seconds."""


def read(values):
    return values["work"] / values["seconds"] / 1e6
