"""lit_skip_roofline.enc: the lit_skip token encoder
(``csrc/sqz4_encode_tok.cu``, ``sqz4_encode_tok_kernel<true>``) as a
share of its roofline, bounded by bytes: a save's raw bytes read once
and its payload bytes written once, at the card's memory bandwidth, over
the kernel's device time. The share is read beside the card's power
limit (``settings``)."""

from portbench.readers import share

KERNELS = r"^sqz4_encode_tok_kernel<true>"


def read(t):
    return share(t, KERNELS)
