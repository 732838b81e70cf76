"""dec_MBps: output bytes (10^6 B) of every load or decompress call in
the window, over the time from the window's start to the end of the last
call."""

from portbench.readers import rate_mb_s


def read(t):
    return rate_mb_s(t)
