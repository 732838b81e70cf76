"""The port's copies of the wire-format constants, the sqzt container
framing and the anchored warm-start planner (``sqz_tpu/formats``; see
FORMAT.md)."""
