"""idle_share.dec: the share of the traced window in which no kernel,
copy or memset ran on the card (``torch.profiler``), in a decoding
cell."""

from portbench.readers import idle_share


def read(t):
    return idle_share(t)
