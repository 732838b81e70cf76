"""decoder_roofline.dec: the sqz4 decoder kernel (``csrc/sqz4_decode.cu``,
``sqz4_decode_kernel``, cold and seeded) as a share of its roofline,
bounded by bytes: a call's payload bytes read once and its decoded bytes
written once, at the card's memory bandwidth, over the kernel's device
time. The share is read beside the card's power limit (``settings``)."""

from portbench.readers import share

KERNELS = r"^sqz4_decode_kernel\b"


def read(t):
    return share(t, KERNELS)
