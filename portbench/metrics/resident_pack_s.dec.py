"""resident_pack_s.dec: seconds a load spends packing payloads into the
decoder's word layout on the host (``ops/resident.py``,
``stats["pack_s"]``)."""

from portbench.readers import mean_stage


def read(t):
    return mean_stage(t, "pack_s")
