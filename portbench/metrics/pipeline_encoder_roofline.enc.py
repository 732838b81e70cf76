"""pipeline_encoder_roofline.enc: the sqz4 encode kernels that
``compress`` launches through the pipeline, whichever transport runs
them (the cold token encoder ``sqz4_encode_tok_kernel<false>``,
``csrc/sqz4_encode_tok.cu``; the op-stream encoder
``sqz4_encode_kernel``, ``csrc/sqz4_encode.cu``), as a share of their
roofline, bounded by bytes: a call's raw bytes read once and its payload
bytes written once, at the card's memory bandwidth, over their device
time. The share is read beside the card's power limit (``settings``)."""

from portbench.readers import share

KERNELS = r"^(sqz4_encode_tok_kernel<false>|sqz4_encode_kernel\b)"


def read(t):
    return share(t, KERNELS)
