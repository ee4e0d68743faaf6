"""Ray samples whose loss and gradients the window's steps yielded, in
millions, over the window's seconds."""


def read(values):
    return values["work"] / values["seconds"] / 1e6
