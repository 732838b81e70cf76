"""ratio: bytes stored (the checkpoint file, the container) over input
bytes, summed over the window's calls."""

from portbench.readers import stored_ratio


def read(t):
    return stored_ratio(t)
