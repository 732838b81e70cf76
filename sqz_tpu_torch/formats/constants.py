"""The wire-format constants the port uses: the sqz4 and sqzt sections of
``sqz_tpu/formats/constants.py`` (FORMAT.md §2-§3), copied."""

SQZ4_MAGIC = b"squeeze4"       # container magic (reference test.c:41)

SQZT_MAGIC = b"sqzTPU01"
SQZT_FORMAT_SQUEEZE = 0
SQZT_FORMAT_SQZ4 = 1
SQZT_HEADER_BYTES = 32         # magic + fmt/win/blk/reserved + size + nblocks
