"""The port's copies of the wire-format constants and the sqzt container
framing (``sqz_tpu/formats``; see FORMAT.md)."""
