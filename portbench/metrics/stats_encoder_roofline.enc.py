"""stats_encoder_roofline.enc: the stats-fed encoder
(``csrc/sqz4_encode_stats.cu``, ``sqz4_encode_stats_kernel``), which
``compress`` launches above 64 KiB blocks, one launch a group of
``sqz4_host.group_lanes`` blocks, as a share of its roofline, bounded by
bytes: a call's raw bytes read once and its payload bytes written once,
at the card's memory bandwidth, over the kernel's device time; the same
work whatever implements it, as ``pipeline_encoder_roofline.enc``
counts. The share is read beside the card's power limit
(``settings``)."""

from portbench.readers import share

KERNELS = r"^sqz4_encode_stats_kernel\b"


def read(t):
    return share(t, KERNELS)
