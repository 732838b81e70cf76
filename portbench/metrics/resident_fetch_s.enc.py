"""resident_fetch_s.enc: seconds a save spends fetching payloads from the
card (``ops/resident.py``, ``stats["fetch_s"]``: the compaction, the
download and the split into payloads), the save's largest stage."""

from portbench.readers import mean_stage


def read(t):
    return mean_stage(t, "fetch_s")
